"""Training engine: loss assembly, the masked-Adam step, eval and parse.

Counterpart of cliora_tpu/training/trainer.py for the slices ported so
far: ``Trainer.step`` (one optimizer step, or the eval step),
``Trainer.steps`` (K same-shape optimizer steps; on the card, one train
step captured as a CUDA graph and replayed), gradient accumulation
(``TrainConfig.accum_steps``), the step counter and state installation a
resumed run needs, and ``Trainer.parse``, the CKY parse of a DIORA or
CLIORA model, with its span x region scores, charts and eval losses on
request, that the parse scripts and analysis/eval.py call in the JAX
package.

The step runs embed -> image encoder -> leaf transform with region
attention -> inside pass with region attention -> outside pass ->
reconstruction, VG and contrastive losses -> backward -> global-norm clip
-> Adam, for the mlp and TreeLSTM composes, with the chart levels
rematerialized in the backward under ``ModelConfig.remat``; the
chart-free ``word`` baseline runs embed -> image encoder -> word x
region scores -> VG loss (:func:`word_grounding_losses`).  Parameters stay f32 whatever ``compute_dtype`` says.  Frozen
parameters get no gradient and no Adam state, so the clip norm is taken
over the trainable ones (reference: cliora/net/trainer.py:450-455).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from cliora_tpu_torch.models.config import ModelConfig
from cliora_tpu_torch.models.diora import (
    diora_forward,
    embed_forward,
    embed_span,
    image_encoder_forward,
    leaf_transform,
)
from cliora_tpu_torch.models.params import init_params, to_device
from cliora_tpu_torch.models.word_grounding import word_grounding_forward
from cliora_tpu_torch.ops import inside_cky
from cliora_tpu_torch.ops.span_region import span_region_max
from cliora_tpu_torch.training.losses import (
    contrastive_loss,
    contrastive_loss_from_scores,
    reconstruction_loss,
    vg_loss,
    vg_loss_from_scores,
)

ATTN_IMPLS = ("einsum", "chunked", "cuda")


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Optimizer + loss configuration.

    (reference flags: cliora/scripts/train.py:337-401; optimizer:
    cliora/net/trainer.py:580)
    """
    lr: float = 5e-4
    grad_clip: float = 5.0
    k_neg: int = 100
    emb_trainable: bool = False     # --emb none and not finetuning
    vg_loss: bool = False           # --vg_loss
    alpha_vg: float = 1.0
    use_contr: bool = False         # --obj_feats --use_contr
    alpha_contr: float = 1.0
    vl_margin: float = 0.2          # --vl_margin (hinge margin)
    freeze: str = "none"            # 'none' | 'diora' | 'except_vis'
    # span x region max reduction in training: 'einsum' materializes the
    # (B, B, cells, R) tensor (reference semantics); 'chunked' and 'cuda'
    # fuse the max (ops/span_region.py), 'cuda' with kernels K2-K4
    attn_impl: str = "einsum"
    # gradient accumulation: split each batch into this many sequential
    # microbatches, average their gradients and metrics, apply ONE update.
    # Batch-coupled losses (the VG and contrastive negatives are the other
    # examples of the batch) see microbatch-sized batches, so this equals
    # `accum_steps` small-batch gradients under one averaged update, not
    # one big-batch step (cliora_tpu/training/trainer.py:64-73)
    accum_steps: int = 1
    # ZeRO-1 comes with the parallelism slice of the port
    zero1: bool = False

    def __post_init__(self):
        if self.freeze not in ("none", "diora", "except_vis"):
            raise ValueError(f"freeze={self.freeze!r}")
        if self.attn_impl not in ATTN_IMPLS:
            raise ValueError(f"attn_impl={self.attn_impl!r}, expected one "
                             f"of {ATTN_IMPLS}")
        if self.accum_steps < 1:
            raise ValueError(f"accum_steps={self.accum_steps}")
        if self.zero1:
            raise NotImplementedError(
                "zero1: sharded optimizer state comes with the parallelism "
                "slice of the port")


def trainable_mask(tc: TrainConfig, params) -> Any:
    """Tree of bools mirroring torch ``requires_grad``.

    (reference: cliora/net/trainer.py:351-358 freeze_diora /
    freeze_except_vis; embedding freeze: trainer.py:536-546)
    """
    def decide(keys) -> bool:
        if tc.freeze == "except_vis":
            return any("_vis" in k for k in keys)
        if "embeddings" in keys:
            return tc.emb_trainable
        if tc.freeze == "diora" and keys[0] == "diora":
            return False
        return True

    def walk(keys, node):
        if isinstance(node, dict):
            return {k: walk(keys + (k,), v) for k, v in node.items()}
        return decide(keys)

    return walk((), params)


def tree_leaves(tree) -> List:
    """The leaves of a nested dict, in the order of ``checkpoint.flatten``."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    return [tree]


def tree_paths(tree, prefix: str = "") -> List[str]:
    """The ``/``-joined key path of each leaf, in :func:`tree_leaves`
    order (the keys of ``checkpoint.flatten``)."""
    if isinstance(tree, dict):
        return [x for k, v in tree.items()
                for x in tree_paths(v, f"{prefix}{k}/")]
    return [prefix[:-1]]


def clip_by_global_norm(grads: List[torch.Tensor], max_norm: float):
    """``g * max_norm / norm`` for every gradient when the global norm is
    at least ``max_norm``, else ``g`` -- ``optax.clip_by_global_norm``'s
    rule (divide by the norm, then multiply), computed on the device with
    no host sync.  (``torch.nn.utils.clip_grad_norm_`` adds 1e-6 to the
    norm and scales below it too, so it would not match.)  Returns
    ``(clipped grads, norm)``."""
    norm = torch.sqrt(sum(torch.sum(torch.square(g)) for g in grads))
    keep = norm < max_norm
    return [torch.where(keep, g, g / norm * max_norm) for g in grads], norm


def make_optimizer(tc: TrainConfig, params, mask,
                   capturable: bool = False) -> torch.optim.Adam:
    """Adam(lr, (0.9, 0.999), 1e-8) over the trainable parameters only;
    the clip (:func:`clip_by_global_norm`) runs before it in
    ``Trainer.step``.  ``torch.optim.Adam``'s update is optax's
    ``adam``: ``m_hat / (sqrt(v_hat) + eps)``.  ``capturable`` keeps the
    step count on the device, so that a CUDA graph can capture the update
    (a CUDA trainer's eager and graphed steps share this one optimizer).

    The state is made here, not at the first step, so that a checkpoint
    can be installed before any step and a captured graph sees the
    tensors every later step updates in place."""
    trainable = [p for p, m in zip(tree_leaves(params), tree_leaves(mask))
                 if m]
    opt = torch.optim.Adam(trainable, lr=tc.lr, betas=(0.9, 0.999),
                           eps=1e-8, capturable=capturable)
    for p in trainable:
        opt.state[p] = {
            "step": (torch.zeros((), dtype=torch.float32, device=p.device)
                     if capturable else torch.tensor(0.0)),
            "exp_avg": torch.zeros_like(p),
            "exp_avg_sq": torch.zeros_like(p),
        }
    return opt


def forward_outputs(cfg: ModelConfig, tc: TrainConfig, params,
                    tokens: torch.Tensor, obj_feats=None,
                    generator: Optional[torch.Generator] = None,
                    train: bool = True, with_cky: bool = False,
                    outside=None, lengths=None):
    """Embed -> image-encode -> diora forward (reference: Net.forward,
    cliora/net/trainer.py:272-304).

    Returns ``(out, aux)``; aux carries the embedding and region vectors
    the fused-score losses need.
    """
    x_span, x_word = embed_forward(params["embed"], tokens,
                                   trainable=tc.emb_trainable)
    obj_span = obj_word = None
    if cfg.use_obj:
        obj_span, obj_word = image_encoder_forward(params["img_encoder"],
                                                   obj_feats)
    need_all_atten = cfg.use_obj and (tc.use_contr or not train)
    out = diora_forward(
        cfg, params, x_span, x_word, obj_span=obj_span, obj_word=obj_word,
        generator=generator, train=train, with_cky=with_cky,
        outside=outside, with_all_atten=need_all_atten,
        materialize_atten=(tc.attn_impl == "einsum"), lengths=lengths)
    aux = {"x_word": x_word, "obj_span": obj_span, "obj_word": obj_word}
    return out, aux


def losses_from(cfg: ModelConfig, tc: TrainConfig, params, tokens,
                neg_samples, out, aux=None,
                lengths=None) -> Dict[str, torch.Tensor]:
    """All enabled losses from forward outputs.

    (reference: Net.compute_loss, cliora/net/trainer.py:243-270)
    """
    metrics: Dict[str, torch.Tensor] = {}
    recon = reconstruction_loss(
        params["reconstruct"], params["embed"]["embeddings"], tokens,
        neg_samples, out.chart.outside_h, lengths=lengths)
    metrics["reconstruction_softmax_loss"] = recon
    total = recon

    # fused reductions replace the materialized tensors only when the
    # forward skipped them (training with attn_impl != 'einsum'); eval
    # keeps the reference's eval-time score mixing (cliora.py:459-464)
    if tc.vg_loss and cfg.use_obj:
        if out.vg_atten_score is None:
            prm = span_region_max(aux["x_word"], aux["obj_word"],
                                  tc.attn_impl)
            vgl = vg_loss_from_scores(prm, alpha_vg=tc.alpha_vg,
                                      lengths=lengths)
        else:
            vgl = vg_loss(out.vg_atten_score, alpha_vg=tc.alpha_vg,
                          lengths=lengths)
        metrics["vg_loss"] = vgl
        total = total + vgl
    if tc.use_contr and cfg.use_obj:
        if out.all_atten_score is None:
            span_vec = out.chart.inside_h + out.chart.outside_h
            scores = span_region_max(span_vec, aux["obj_span"], tc.attn_impl)
            ctr = contrastive_loss_from_scores(
                out.chart.inside_s, out.chart.outside_s, scores,
                margin=tc.vl_margin, alpha_contr=tc.alpha_contr,
                lengths=lengths)
        else:
            ctr = contrastive_loss(
                out.chart.inside_s, out.chart.outside_s, out.all_atten_score,
                margin=tc.vl_margin, alpha_contr=tc.alpha_contr,
                lengths=lengths)
        metrics["contrastive_loss"] = ctr
        total = total + ctr

    metrics["total_loss"] = total
    return metrics


def word_grounding_losses(cfg: ModelConfig, tc: TrainConfig, params,
                          tokens, obj_feats, lengths=None):
    """The chart-free ``word`` baseline's forward and its one loss, the VG
    InfoNCE over the word x region scores.  Returns ``(out, metrics)``.
    (cliora_tpu/training/trainer.py:196-211; reference:
    cliora/net/vg.py:477-482)
    """
    _, x_word = embed_forward(params["embed"], tokens,
                              trainable=tc.emb_trainable)
    _, obj_word = image_encoder_forward(params["img_encoder"], obj_feats)
    wg = word_grounding_forward(x_word, obj_word)
    vgl = vg_loss(wg.vg_atten_score, alpha_vg=tc.alpha_vg, lengths=lengths)
    return wg, {"vg_loss": vgl, "total_loss": vgl}


def compute_losses(cfg: ModelConfig, tc: TrainConfig, params, tokens,
                   neg_samples, obj_feats=None,
                   generator: Optional[torch.Generator] = None,
                   train: bool = True, lengths=None):
    """Forward + all enabled losses; returns ``(total, metrics)``."""
    if cfg.arch == "word":
        _, metrics = word_grounding_losses(cfg, tc, params, tokens,
                                           obj_feats, lengths=lengths)
        return metrics["total_loss"], metrics
    out, aux = forward_outputs(cfg, tc, params, tokens, obj_feats=obj_feats,
                               generator=generator, train=train,
                               lengths=lengths)
    metrics = losses_from(cfg, tc, params, tokens, neg_samples, out, aux,
                          lengths=lengths)
    return metrics["total_loss"], metrics


def _default_device() -> torch.device:
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on the GPU unless the caller "
            "asks for the CPU (device='cpu')")
    return torch.device("cuda")


# seed of the dropout stream; step k draws from a generator seeded with
# DROPOUT_SEED + k
DROPOUT_SEED = 1729
# eager steps of each new batch shape, on a side stream, before
# ``Trainer.steps`` captures its graph (PyTorch's whole-network capture
# warms up so): they are real steps of the batches given
GRAPH_WARMUP_STEPS = 2


def _end_failed_capture(capture, device, pool):
    """Undo what a failed ``torch.cuda.graph`` capture leaves behind: its
    capture stream stays the current stream, and the caching allocator
    keeps routing the device's allocations to the graph's pool, so that
    ``empty_cache`` and the allocator's own out-of-memory retry release
    no cached block again (seen with torch 2.11 on an H100)."""
    if torch.cuda.current_stream(device) == capture.capture_stream:
        capture.stream_ctx.__exit__(None, None, None)
    try:
        torch._C._cuda_endAllocateToPool(
            torch.cuda.current_device() if device.index is None
            else device.index, pool)
    except RuntimeError:
        pass                # the capture ended its pool routing itself


class _StepGraph:
    """One train step captured as a CUDA graph, with the static input
    buffers that each replay copies its batch into.

    The dropout generator is registered with the graph and reseeded
    before each replay, so replay k draws what an eager step with the
    generator of step k draws.  Everything else the step writes (the
    parameters, Adam's state, its device step count) lives outside the
    graph's memory pool and is updated in place, so it stays valid for
    every replay.

    All graphs of a trainer share one memory pool (``pool``), so memory
    grows with the largest shape rather than with the number of shapes.
    That is sound because replays run one at a time on one stream, each
    replay's outputs are copied out before the next (:meth:`replay`), and
    what must outlive a replay -- static inputs, parameters, optimizer
    state, the chart index cache (filled by the eager warm-up steps) --
    is allocated outside the pool."""

    def __init__(self, trainer: "Trainer", batch, pool):
        self.inputs = [None if x is None else x.clone() for x in batch]
        self.generator = torch.Generator(device=trainer.device)
        self.graph = torch.cuda.CUDAGraph()
        self.graph.register_generator_state(self.generator)
        capture = torch.cuda.graph(self.graph, pool=pool)
        try:
            with capture:
                metrics = trainer._train_step(*self.inputs, self.generator)
                self.names = list(metrics)
                self.out = torch.stack([metrics[k].float()
                                        for k in self.names])
        except BaseException:
            _end_failed_capture(capture, trainer.device, pool)
            raise

    def replay(self, batch, seed: int) -> Dict[str, torch.Tensor]:
        for dst, src in zip(self.inputs, batch):
            if dst is not None:
                dst.copy_(src)
        self.generator.manual_seed(seed)
        self.graph.replay()
        # the next replay overwrites the graph's outputs
        vals = self.out.clone()
        return {k: vals[i] for i, k in enumerate(self.names)}


class Trainer:
    """Holds the model config, the parameters, the optimizer and their
    device.

    (reference: cliora/net/trainer.py:337-501 ``Trainer``)
    """

    def __init__(self, cfg: ModelConfig, tc: TrainConfig, params,
                 device=None):
        self.cfg = cfg
        self.tc = tc
        self.device = (_default_device() if device is None
                       else torch.device(device))
        self.params = to_device(params, self.device)
        self.mask = trainable_mask(tc, self.params)
        for p, m in zip(tree_leaves(self.params), tree_leaves(self.mask)):
            p.requires_grad_(m)
        self.optimizer = make_optimizer(
            tc, self.params, self.mask,
            capturable=self.device.type == "cuda")
        # host-side step counter for the dropout stream: reading a device
        # counter would sync every step
        self._host_step = 0
        # Trainer.steps on the card: one graph per batch shape key, the
        # memory pool they share, the warm-up steps taken so far for a key
        # without one, and each capture's wall seconds
        self._graphs: Dict[tuple, _StepGraph] = {}
        self._graph_pool = None
        self._warmed: Dict[tuple, int] = {}
        self._side_stream = None
        self.capture_seconds: Dict[tuple, float] = {}

    @classmethod
    def build(cls, cfg: ModelConfig, tc: TrainConfig, embeddings,
              seed: int = 0, device=None) -> "Trainer":
        """New model with N(0, 1) weights drawn from ``seed``.

        (reference: cliora/net/trainer.py:504-582 ``build_net``)
        ``device=None`` means the CUDA device, and raises without one.
        """
        device = _default_device() if device is None else torch.device(device)
        gen = torch.Generator().manual_seed(seed)
        return cls(cfg, tc, init_params(gen, cfg, embeddings, device),
                   device=device)

    def _place_batch(self, batch_map):
        """The batch's arrays as tensors on this trainer's device: numpy
        arrays are uploaded, tensors already there are used as they are
        (a prefetching pipeline keeps batches on the device)."""
        def put(x, dtype):
            if not isinstance(x, torch.Tensor):
                x = np.asarray(x)
            return torch.as_tensor(x, dtype=dtype, device=self.device)

        tokens = put(batch_map["sentences"], torch.int64)
        neg = put(batch_map["neg_samples"], torch.int64)
        obj = batch_map.get("obj_feats")
        obj = None if obj is None else put(obj, torch.float32)
        lengths = batch_map.get("lengths")
        lengths = None if lengths is None else put(lengths, torch.int64)
        return tokens, neg, obj, lengths

    def dropout_generator(self, step: int) -> torch.Generator:
        """The dropout stream of train step ``step``.  Dropout carries no
        parity contract with the JAX package (its draws come from
        ``jax.random``)."""
        gen = torch.Generator(device=self.device)
        gen.manual_seed(DROPOUT_SEED + step)
        return gen

    def step(self, batch_map: Dict[str, Any], train: bool = True,
             generator: Optional[torch.Generator] = None):
        """One optimization step (``train=True``) or one eval step from a
        host-side batch_map.

        batch_map: {'sentences': (B, L) int, 'neg_samples': (k,) int,
                    'obj_feats': (B, R, F) float (CLIORA),
                    'lengths': optional (B,) true lengths}, numpy
        arrays or tensors
        ``generator`` overrides the step's dropout stream and leaves the
        host step counter where it was; without it the step draws from
        ``dropout_generator(host step)`` and advances the counter
        (cliora_tpu/training/trainer.py:657-659).  The eval step
        materializes the attention scores and mixes ``vg_atten`` as at
        eval (cliora.py:462-464).  Returns a dict of device-resident
        scalar tensors: nothing here waits for the device (float() them
        when logging).  This step always runs eagerly; ``steps`` is the
        graphed route.
        """
        tokens, neg, obj, lengths = self._place_batch(batch_map)
        if not train:
            with torch.no_grad():
                _, metrics = compute_losses(
                    self.cfg, self.tc, self.params, tokens, neg,
                    obj_feats=obj, train=False, lengths=lengths)
            return metrics
        if generator is not None:
            return self._train_step(tokens, neg, obj, lengths, generator)
        metrics = self._train_step(tokens, neg, obj, lengths,
                                   self.dropout_generator(self._host_step))
        self._host_step += 1
        return metrics

    def _train_step(self, tokens, neg, obj, lengths, generator):
        """Forward, backward, clip and Adam on placed tensors; the body of
        both the eager and the captured step.  With ``accum_steps`` A > 1
        the batch is cut into A microbatches whose gradients accumulate
        from zero and, with the metrics, are divided by A before the one
        clip and update (cliora_tpu/training/trainer.py:356-411); each
        microbatch draws the next stretch of the step's dropout stream."""
        A = self.tc.accum_steps
        B = tokens.shape[0]
        if B % A:
            raise ValueError(f"batch {B} not divisible by accum_steps {A}")
        b = B // A
        trainable = self.optimizer.param_groups[0]["params"]
        self.optimizer.zero_grad(set_to_none=True)
        metrics = None
        for i in range(A):
            part = slice(i * b, (i + 1) * b)
            total, m = compute_losses(
                self.cfg, self.tc, self.params, tokens[part], neg,
                obj_feats=None if obj is None else obj[part],
                generator=generator, train=True,
                lengths=None if lengths is None else lengths[part])
            total.backward()
            m = {k: v.detach() for k, v in m.items()}
            metrics = m if metrics is None else {
                k: metrics[k] + m[k] for k in m}
        grads = [torch.zeros_like(p) if p.grad is None else p.grad
                 for p in trainable]
        if A > 1:
            grads = [g / A for g in grads]
            metrics = {k: v / A for k, v in metrics.items()}
        clipped, _ = clip_by_global_norm(grads, self.tc.grad_clip)
        for p, g in zip(trainable, clipped):
            p.grad = g
        self.optimizer.step()
        return metrics

    def _graph_key(self, batch) -> tuple:
        """The shapes a captured step is specialised to: B, L, k_neg, R,
        F (None without regions), ``lengths`` given or not, and
        ``accum_steps``."""
        tokens, neg, obj, lengths = batch
        return (*tokens.shape, neg.shape[0],
                *((None, None) if obj is None else obj.shape[1:]),
                lengths is not None, self.tc.accum_steps)

    def steps(self, batch_maps) -> List[Dict[str, torch.Tensor]]:
        """``len(batch_maps)`` train steps on batches of one shape, which
        leave exactly the state of as many ``step`` calls.  Returns one
        dict of device-resident scalars per step, with no host sync.

        On a CUDA trainer one train step (forward, backward, clip, Adam) is
        captured as a CUDA graph per shape key (:meth:`_graph_key`) and
        replayed for each batch: the batch is copied into the graph's
        static inputs and the dropout generator reseeded to the step's
        seed.  The first ``GRAPH_WARMUP_STEPS`` batches of a new shape run
        eagerly on a side stream before the capture.  A capture that fails
        raises; no eager step runs in its place.  On the CPU the steps run
        eagerly.  (reference: cliora_tpu/training/trainer.py:670-707
        ``steps``, :425-448 ``multi_step``)
        """
        if not batch_maps:
            raise ValueError("steps needs at least one batch")
        placed = [self._place_batch(bm) for bm in batch_maps]
        keys = {self._graph_key(b) for b in placed}
        if len(keys) != 1:
            raise ValueError(f"steps needs batches of one shape: {keys}")
        (key,) = keys
        out = []
        for batch in placed:
            if self.device.type == "cuda":
                out.append(self._graphed_step(key, batch))
            else:
                out.append(self._train_step(
                    *batch, self.dropout_generator(self._host_step)))
            self._host_step += 1
        return out

    def _graphed_step(self, key, batch):
        graph = self._graphs.get(key)
        if graph is None:
            warmed = self._warmed.get(key, 0)
            if warmed < GRAPH_WARMUP_STEPS:
                self._warmed[key] = warmed + 1
                return self._side_stream_step(batch)
            if self._graph_pool is None:
                self._graph_pool = torch.cuda.graph_pool_handle()
            t0 = time.perf_counter()
            try:
                graph = _StepGraph(self, batch, self._graph_pool)
            except RuntimeError as err:
                # the failed capture leaves its pool marked as capturing:
                # later captures start a pool of their own
                self._graph_pool = None
                raise RuntimeError(
                    f"CUDA graph capture of the train step failed for shape "
                    f"key {key}; no step ran") from err
            self.capture_seconds[key] = time.perf_counter() - t0
            self._graphs[key] = graph
        return graph.replay(batch, DROPOUT_SEED + self._host_step)

    def _side_stream_step(self, batch):
        """An eager step on a side stream, ordered after and before the
        current stream's work."""
        current = torch.cuda.current_stream(self.device)
        if self._side_stream is None:
            self._side_stream = torch.cuda.Stream(self.device)
        side = self._side_stream
        side.wait_stream(current)
        with torch.cuda.stream(side):
            metrics = self._train_step(
                *batch, self.dropout_generator(self._host_step))
        current.wait_stream(side)
        return metrics

    def _trainable(self):
        """``(path, parameter)`` of each trainable parameter, in the
        optimizer's order."""
        return [(k, p) for k, p, m in zip(tree_paths(self.params),
                                          tree_leaves(self.params),
                                          tree_leaves(self.mask)) if m]

    def set_step(self, n: int):
        """Restore the host step counter, which keys the dropout stream
        (:meth:`dropout_generator`), for exact resume
        (cliora_tpu/training/trainer.py:561-571 ``set_step``).  Adam's
        step count is left alone: only ``install_state(opt_state=...)``
        writes it."""
        self._host_step = int(n)

    def opt_state(self) -> Dict[str, Any]:
        """Adam's state on the host: ``{"count": int, "mu": {path: array},
        "nu": {path: array}}`` over the trainable parameters, the form
        ``checkpoint.save_opt_state`` writes, copied to the host.  Syncs
        with the device."""
        def host(t):      # a copy: the next step updates ``t`` in place
            return t.detach().to("cpu", copy=True).numpy()

        out = {"count": 0, "mu": {}, "nu": {}}
        for path, p in self._trainable():
            st = self.optimizer.state[p]
            out["count"] = int(st["step"])
            out["mu"][path] = host(st["exp_avg"])
            out["nu"][path] = host(st["exp_avg_sq"])
        return out

    @torch.no_grad()
    def install_state(self, params=None, opt_state=None):
        """Write loaded parameters (a tree shaped like ``self.params``, of
        tensors or arrays) and optimizer state (the form of
        :meth:`opt_state`; its count becomes every parameter's Adam step)
        into this trainer's tensors with ``copy_``.  Nothing is rebound,
        so captured graphs stay valid (cliora_tpu/training/trainer.py:
        531-559 ``install_state``, without a mesh).  Raises
        ``ValueError`` on a missing path or a shape that differs."""
        def put(dst, src, what):
            src = torch.as_tensor(src)
            if tuple(src.shape) != tuple(dst.shape):
                raise ValueError(f"{what}: shape {tuple(src.shape)} != "
                                 f"{tuple(dst.shape)}")
            dst.copy_(src)

        if params is not None:
            flat = dict(zip(tree_paths(params), tree_leaves(params)))
            for path, p in zip(tree_paths(self.params),
                               tree_leaves(self.params)):
                if path not in flat:
                    raise ValueError(f"params: no {path}")
                put(p, flat[path], path)
        if opt_state is not None:
            trainable = self._trainable()
            names = {k for k, _ in trainable}
            for part in ("mu", "nu"):
                if set(opt_state[part]) != names:
                    raise ValueError(
                        f"opt_state {part}: paths "
                        f"{sorted(set(opt_state[part]) ^ names)} do not "
                        f"match the trainable parameters")
            for path, p in trainable:
                st = self.optimizer.state[p]
                put(st["exp_avg"], opt_state["mu"][path], "mu/" + path)
                put(st["exp_avg_sq"], opt_state["nu"][path], "nu/" + path)
                st["step"].fill_(float(opt_state["count"]))

    def parameter_norm(self, trainable_only: bool = True) -> float:
        """Sum of per-parameter L2 norms (reference: trainer.py:360-367)."""
        total = 0.0
        for p, m in zip(tree_leaves(self.params), tree_leaves(self.mask)):
            if trainable_only and not m:
                continue
            total += float(torch.linalg.vector_norm(p.detach().reshape(-1)))
        return total

    def _route(self, impl: Optional[str], batch_map,
               compute_loss: bool = False, with_chart: bool = False,
               outside: Optional[bool] = None) -> str:
        impl = impl or self.cfg.parse_impl
        if impl not in ("auto", "plain", "cuda"):
            raise ValueError(f"impl={impl!r}")
        if impl == "auto":
            impl = "cuda" if self.device.type == "cuda" else "plain"
        if impl == "cuda" and self.device.type != "cuda":
            raise ValueError("impl='cuda' needs a trainer on a CUDA device")
        # the fused kernel implements the text-only mlp compose + soft
        # split softmax over full-length sentences, and returns
        # backpointers only (the JAX package's gating,
        # cliora_tpu/training/trainer.py:745-757): TreeLSTM params have
        # no fc0/fc1 and no c chart there
        if impl == "cuda":
            B, n = np.shape(batch_map["sentences"])
            if (compute_loss or with_chart or outside or self.cfg.use_obj
                    or self.cfg.arch != "mlp"
                    or self.cfg.aggregate != "soft"
                    or batch_map.get("lengths") is not None
                    or not inside_cky.supports(n, self.cfg.size, B,
                                               self.cfg.compute_dtype)):
                impl = "plain"
        return impl

    @torch.no_grad()
    def parse(self, batch_map: Dict[str, Any], compute_loss: bool = False,
              outside: Optional[bool] = None, with_chart: bool = False,
              impl: Optional[str] = None):
        """Eval forward with CKY.  Returns ``(res, metrics)``.

        ``batch_map``: {'sentences': (B, L) int, and optionally
        'neg_samples' (k,) int (a ``(1,)`` zero when absent), 'obj_feats'
        (B, R, F) (CLIORA), 'lengths' (B,) true lengths of a padded
        batch}.  ``outside`` defaults to ``cfg.use_obj``; ``compute_loss``
        forces it on (the losses need the outside chart).

        ``res`` holds numpy arrays: ``cky_bp`` (B, ncells) int32; for a
        CLIORA model ``atten_score`` (B, L, R), the eval-time word x region
        scores (span and word branches mixed, cliora.py:462-466) of each
        sentence against its own image, and ``span_scores`` (B,
        ncells, R), the diagonal of the span x region scores; under
        ``with_chart`` ``inside_h`` and, when the outside pass ran,
        ``outside_h`` (B, ncells, D), as float32 whatever the chart dtype.
        ``res["parse_impl"]`` is the route that decoded the batch: "cuda"
        (kernel K1) or "plain" (the chart pass).  ``metrics`` maps each
        loss of ``losses_from(..., train=False)`` to a float under
        ``compute_loss``, else is empty.

        The chart-free ``word`` baseline returns ``atten_score`` alone (no
        trees; cliora_tpu/training/trainer.py:463-468), with its VG loss
        under ``compute_loss``.

        Routing keeps the JAX package's gating: a CLIORA model, a TreeLSTM
        or ``word`` model, a padded batch, and any request for losses,
        charts or the outside pass take the plain route.  ``impl`` overrides ``cfg.parse_impl``.  The two
        routes group fc0's sums differently (the kernel adds ``W0[:, :D]
        l`` and ``W0[:, D:] r``; the plain chart pass takes one product
        over ``[l; r]``), so at f32 a near-tie split can still pick
        another backpointer on rare cells; under bf16 charts the split
        scores also round at different points.  Published trees are
        therefore attributed to their route.
        """
        route = self._route(impl, batch_map, compute_loss, with_chart,
                            outside)
        if route == "cuda":
            tokens = torch.as_tensor(np.asarray(batch_map["sentences"]),
                                     dtype=torch.int64).to(self.device)
            dp = self.params["diora"]
            h0, _ = leaf_transform(self.cfg, dp,
                                embed_span(self.params["embed"], tokens))
            _, bp, _ = inside_cky.fused_inside_cky(
                dp, h0, norm=self.cfg.normalize,
                compute_dtype=self.cfg.compute_dtype)
            return {"cky_bp": bp.cpu().numpy(), "parse_impl": route}, {}

        if outside is None:
            outside = self.cfg.use_obj
        if compute_loss:
            outside = True
        if batch_map.get("neg_samples") is None:
            batch_map = {**batch_map, "neg_samples": np.zeros(1, np.int64)}
        tokens, neg, obj, lengths = self._place_batch(batch_map)
        if self.cfg.arch == "word":
            # chart-free baseline: no trees, grounding scores only
            wg, metrics = word_grounding_losses(
                self.cfg, self.tc, self.params, tokens, obj, lengths=lengths)
            res = {"atten_score": wg.atten_score.cpu().numpy(),
                   "parse_impl": route}
            return res, ({k: float(v) for k, v in metrics.items()}
                         if compute_loss else {})
        out, aux = forward_outputs(
            self.cfg, self.tc, self.params, tokens, obj_feats=obj,
            train=False, with_cky=True, outside=outside, lengths=lengths)
        res = {"cky_bp": out.chart.cky_bp}
        if with_chart:
            res["inside_h"] = out.chart.inside_h
            if outside:
                res["outside_h"] = out.chart.outside_h
        if self.cfg.use_obj:
            ar = torch.arange(tokens.shape[0], device=self.device)
            res["atten_score"] = out.atten_score
            # per-example diagonal of the span x region scores
            # (reference: cliora/scripts/parse.py:169-172)
            res["span_scores"] = out.all_atten_score[ar, ar]
        metrics = {}
        if compute_loss:
            metrics = losses_from(self.cfg, self.tc, self.params, tokens,
                                  neg, out, aux, lengths=lengths)
        res = {k: (v.float() if v.is_floating_point() else v).cpu().numpy()
               for k, v in res.items()}
        res["parse_impl"] = route
        return res, {k: float(v) for k, v in metrics.items()}
