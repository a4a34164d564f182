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

With a data-parallel ``mesh`` (parallel/mesh.py) each rank steps on its
rows of the global batch: the losses are its shares of the global
batch's losses (training/losses.py), one all-reduce of the flat
gradient comes between backward and the clip, and the metrics are the
global losses.  ``TrainConfig.zero1`` shards Adam's state over the group
(parallel/sharding.py).  Under ``Trainer.steps`` on the card the
collectives run inside the captured graph (NCCL).

With a mesh of ``mp > 1`` (tensor parallelism, parallel/sharding.py)
the trainer holds the rank's slices of the cut weights: the forward
passes run the sharded compose, scores, embed, image encoder and
reconstruction projections (:class:`TensorParallel`), the clip norm
sums the cut parameters' squares over the mp group, Adam (or ZeRO-1,
over the dp group) updates the slices, and :meth:`opt_state`,
:meth:`full_params` and :meth:`install_state` speak in whole tensors,
so checkpoints are those of a run without a group.  The span x region
kernels K2-K4 take whole vectors on every rank and keep running; the
parse takes the plain route, as under the JAX package's mp gating.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

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
from cliora_tpu_torch.ops.core import RankRows
from cliora_tpu_torch.ops.span_region import phase_marker, span_region_max
from cliora_tpu_torch.parallel.mesh import (
    all_gather_rows,
    all_reduce_,
    all_reduce_flat,
    dp_size,
    gather_rows,
    replicate_tree,
)
from cliora_tpu_torch.parallel.sharding import (
    NO_TP,
    TensorParallel,
    Zero1,
    gather_mp,
    gather_params,
    mp_slice,
    shard_dims,
    shard_params,
    tensor_parallel,
)
from cliora_tpu_torch.training.losses import (
    contrastive_loss,
    contrastive_loss_from_scores,
    reconstruction_loss,
    vg_loss,
    vg_loss_from_scores,
)
from cliora_tpu_torch.utils import observability as obs
from cliora_tpu_torch.utils import prng

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
    # Under a dp mesh microbatch i is rows [i*B/A, (i+1)*B/A) of the
    # GLOBAL batch, as in the JAX dp step (its accumulation scan slices
    # the dp-sharded global batch), each rank taking its block of them
    accum_steps: int = 1
    # ZeRO-1: Adam's state and update sharded over the dp group
    # (parallel/sharding.py); the parameters stay replicated
    zero1: bool = False

    def __post_init__(self):
        if self.freeze not in ("none", "diora", "except_vis"):
            raise ValueError(f"freeze={self.freeze!r}")
        if self.attn_impl not in ATTN_IMPLS:
            raise ValueError(f"attn_impl={self.attn_impl!r}, expected one "
                             f"of {ATTN_IMPLS}")
        if self.accum_steps < 1:
            raise ValueError(f"accum_steps={self.accum_steps}")


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


def clip_by_global_norm(grads: List[torch.Tensor], max_norm: float,
                        cut: Optional[List[bool]] = None, mesh=None):
    """``g * max_norm / norm`` for every gradient when the global norm is
    at least ``max_norm``, else ``g`` -- ``optax.clip_by_global_norm``'s
    rule (divide by the norm, then multiply), computed on the device with
    no host sync.  (``torch.nn.utils.clip_grad_norm_`` adds 1e-6 to the
    norm and scales below it too, so it would not match.)  Returns
    ``(clipped grads, norm)``.

    Under tensor parallelism (``mesh`` with ``mp > 1``) ``cut`` flags the
    gradients that are the rank's slices of a cut parameter: their
    squares are summed over the mp group, the replicated ones counted
    once."""
    if mesh is None or mesh.mp == 1 or not any(cut or ()):
        sq = sum(torch.sum(torch.square(g)) for g in grads)
    else:
        zero = grads[0].new_zeros(())
        parts = [torch.sum(torch.square(g)) for g in grads]
        cut_sq = sum((x for x, c in zip(parts, cut) if c), zero)
        dist.all_reduce(cut_sq, group=mesh.mp_group)
        sq = sum((x for x, c in zip(parts, cut) if not c), zero) + cut_sq
    norm = torch.sqrt(sq)
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
                    outside=None, lengths=None, mesh=None,
                    tp: TensorParallel = NO_TP):
    """Embed -> image-encode -> diora forward (reference: Net.forward,
    cliora/net/trainer.py:272-304).

    Returns ``(out, aux)``; aux carries the embedding and region vectors
    the fused-score losses need.  Under a dp ``mesh`` the batch x batch
    scores are left to :func:`losses_from`, which scores the rank's
    texts against every rank's images.  ``tp``: the tensor-parallel
    split of the weights (parallel/sharding.py), whole without one.
    """
    x_span, x_word = embed_forward(params["embed"], tokens,
                                   trainable=tc.emb_trainable, mp=tp.embed)
    obj_span = obj_word = None
    if cfg.use_obj:
        obj_span, obj_word = image_encoder_forward(
            params["img_encoder"], obj_feats, mp=tp.regions)
    need_all_atten = cfg.use_obj and (tc.use_contr or not train)
    out = diora_forward(
        cfg, params, x_span, x_word, obj_span=obj_span, obj_word=obj_word,
        generator=generator, train=train, with_cky=with_cky,
        outside=outside, with_all_atten=need_all_atten,
        materialize_atten=(tc.attn_impl == "einsum" and mesh is None),
        lengths=lengths, mp=tp.hidden)
    aux = {"x_word": x_word, "obj_span": obj_span, "obj_word": obj_word}
    return out, aux


def _images(aux, key, mesh):
    """The region embeddings the batch x batch scores run over: the
    batch's own, or under a dp ``mesh`` every rank's (gathered here,
    just before their one use, so that their gradients reach the rank's
    embeddings in the order the one-process step adds them)."""
    return aux[key] if mesh is None else gather_rows(aux[key], mesh)


def losses_from(cfg: ModelConfig, tc: TrainConfig, params, tokens,
                neg_samples, out, aux=None, lengths=None,
                mesh=None, tp: TensorParallel = NO_TP
                ) -> Dict[str, torch.Tensor]:
    """All enabled losses from forward outputs; under a dp ``mesh`` the
    rank's shares of the global batch's losses (training/losses.py).

    (reference: Net.compute_loss, cliora/net/trainer.py:243-270)
    """
    metrics: Dict[str, torch.Tensor] = {}
    recon = reconstruction_loss(
        params["reconstruct"], params["embed"]["embeddings"], tokens,
        neg_samples, out.chart.outside_h, lengths=lengths, mesh=mesh,
        mp=tp.embed)
    metrics["reconstruction_softmax_loss"] = recon
    total = recon

    # fused reductions replace the materialized tensors only when the
    # forward skipped them (training with attn_impl != 'einsum', or any
    # dp step); eval keeps the reference's eval-time score mixing
    # (cliora.py:459-464)
    if tc.vg_loss and cfg.use_obj:
        if out.vg_atten_score is None:
            obj_word = _images(aux, "obj_word", mesh)
            if tc.attn_impl == "einsum":
                # (cliora.py:459-461), the materialized route of a dp step
                vgl = vg_loss(
                    torch.einsum("ald,crd->aclr", aux["x_word"], obj_word),
                    alpha_vg=tc.alpha_vg, lengths=lengths, mesh=mesh)
            else:
                prm = span_region_max(aux["x_word"], obj_word, tc.attn_impl)
                vgl = vg_loss_from_scores(prm, alpha_vg=tc.alpha_vg,
                                          lengths=lengths, mesh=mesh)
        else:
            vgl = vg_loss(out.vg_atten_score, alpha_vg=tc.alpha_vg,
                          lengths=lengths)
        metrics["vg_loss"] = vgl
        total = total + vgl
    if tc.use_contr and cfg.use_obj:
        if out.all_atten_score is None:
            span_vec = out.chart.inside_h + out.chart.outside_h
            obj_span = _images(aux, "obj_span", mesh)
            if tc.attn_impl == "einsum":
                # (cliora.py:457), the materialized route of a dp step
                ctr = contrastive_loss(
                    out.chart.inside_s, out.chart.outside_s,
                    torch.einsum("and,crd->acnr", span_vec.float(),
                                 obj_span),
                    margin=tc.vl_margin, alpha_contr=tc.alpha_contr,
                    lengths=lengths, mesh=mesh)
            else:
                scores = span_region_max(span_vec, obj_span, tc.attn_impl)
                ctr = contrastive_loss_from_scores(
                    out.chart.inside_s, out.chart.outside_s, scores,
                    margin=tc.vl_margin, alpha_contr=tc.alpha_contr,
                    lengths=lengths, mesh=mesh)
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
                          tokens, obj_feats, lengths=None, mesh=None,
                          tp: TensorParallel = NO_TP):
    """The chart-free ``word`` baseline's forward and its one loss, the VG
    InfoNCE over the word x region scores.  Returns ``(out, metrics)``;
    under a dp ``mesh`` (training) ``out`` is None and the loss is the
    rank's share, over every rank's images.
    (cliora_tpu/training/trainer.py:196-211; reference:
    cliora/net/vg.py:477-482)
    """
    _, x_word = embed_forward(params["embed"], tokens,
                              trainable=tc.emb_trainable, mp=tp.embed)
    _, obj_word = image_encoder_forward(params["img_encoder"], obj_feats,
                                        mp=tp.regions)
    if mesh is not None:
        vg = torch.einsum("ald,crd->aclr", x_word,
                          gather_rows(obj_word, mesh))
        vgl = vg_loss(vg, alpha_vg=tc.alpha_vg, lengths=lengths, mesh=mesh)
        return None, {"vg_loss": vgl, "total_loss": vgl}
    wg = word_grounding_forward(x_word, obj_word)
    vgl = vg_loss(wg.vg_atten_score, alpha_vg=tc.alpha_vg, lengths=lengths)
    return wg, {"vg_loss": vgl, "total_loss": vgl}


def compute_losses(cfg: ModelConfig, tc: TrainConfig, params, tokens,
                   neg_samples, obj_feats=None,
                   generator: Optional[torch.Generator] = None,
                   train: bool = True, lengths=None, mesh=None,
                   tp: TensorParallel = NO_TP):
    """Forward + all enabled losses; returns ``(total, metrics)``.  Under
    a dp ``mesh`` (training only) the losses are the rank's shares of the
    global batch's and ``generator`` is the rank's :class:`RankRows`;
    ``tp`` splits the weights over an mp group."""
    if cfg.arch == "word":
        _, metrics = word_grounding_losses(cfg, tc, params, tokens,
                                           obj_feats, lengths=lengths,
                                           mesh=mesh, tp=tp)
        return metrics["total_loss"], metrics
    out, aux = forward_outputs(cfg, tc, params, tokens, obj_feats=obj_feats,
                               generator=generator, train=train,
                               lengths=lengths, mesh=mesh, tp=tp)
    metrics = losses_from(cfg, tc, params, tokens, neg_samples, out, aux,
                          lengths=lengths, mesh=mesh, tp=tp)
    return metrics["total_loss"], metrics


def _default_device() -> torch.device:
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on the GPU unless the caller "
            "asks for the CPU (device='cpu')")
    return torch.device("cuda", torch.cuda.current_device())


def _resolve_device(device) -> torch.device:
    """``device``, with a bare ``"cuda"`` made the current card (a dp
    rank's, parallel/multihost.py sets it), and ``None`` the same."""
    if device is None:
        return _default_device()
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return _default_device()
    return device


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
        """Copy ``batch`` in, reseed, launch the graph and copy its outputs
        out, as the tracing registry's spans ``train.copy_in``,
        ``train.reseed``, ``train.launch`` and ``train.collect``.
        ``train.launch`` holds any wait for room in the device's launch
        queue, so with steps in flight it follows the device's time, not
        the host's own."""
        with obs.span("train.copy_in"):
            for dst, src in zip(self.inputs, batch):
                if dst is not None:
                    dst.copy_(src)
        with obs.span("train.reseed"):
            self.generator.manual_seed(seed)
        with obs.span("train.launch"):
            self.graph.replay()
        with obs.span("train.collect"):
            # the next replay overwrites the graph's outputs
            vals = self.out.clone()
        obs.count("train.replays")
        return {k: vals[i] for i, k in enumerate(self.names)}


class Trainer:
    """Holds the model config, the parameters, the optimizer and their
    device.

    (reference: cliora/net/trainer.py:337-501 ``Trainer``)
    """

    def __init__(self, cfg: ModelConfig, tc: TrainConfig, params,
                 device=None, mesh=None):
        self.cfg = cfg
        self.tc = tc
        self.mesh = mesh
        self.device = _resolve_device(device)
        params = to_device(params, self.device)
        # tensor parallelism: the dim each leaf is cut on (None: whole),
        # the whole shapes, and the rank's slices in place of the leaves
        mp = 1 if mesh is None else mesh.mp
        self.tp = tensor_parallel(cfg, mesh)
        self.shard_dims = shard_dims(params, mp)
        self._dim_of = dict(zip(tree_paths(self.shard_dims),
                                tree_leaves(self.shard_dims)))
        self.full_shapes = dict(zip(tree_paths(params),
                                    [tuple(p.shape) for p in
                                     tree_leaves(params)]))
        self.params = (params if mp == 1
                       else shard_params(mesh, params, self.shard_dims))
        self.mask = trainable_mask(tc, self.params)
        for p, m in zip(tree_leaves(self.params), tree_leaves(self.mask)):
            p.requires_grad_(m)
        # every rank starts from rank 0's values
        # (cliora_tpu/parallel/mesh.py replicate_tree)
        replicate_tree(mesh, tree_leaves(self.params))
        capturable = self.device.type == "cuda"
        # ZeRO-1 (parallel/sharding.py) owns the optimizer of the rank's
        # slice of the flat trainable parameters
        self.zero1 = (Zero1(self.trainable_params(), tc, mesh, capturable,
                            cut=self._trainable_cut())
                      if tc.zero1 else None)
        self.optimizer = (self.zero1.optimizer if self.zero1 is not None
                          else make_optimizer(tc, self.params, self.mask,
                                              capturable=capturable))
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
              seed: int = 0, device=None, mesh=None) -> "Trainer":
        """New model with N(0, 1) weights drawn from ``seed``.

        (reference: cliora/net/trainer.py:504-582 ``build_net``)
        ``device=None`` means the current CUDA device, and raises without
        one.  ``mesh``: the data-parallel group (parallel/mesh.py); every
        rank passes its own rows of each global batch.
        """
        device = _resolve_device(device)
        return cls(cfg, tc, init_params(prng.PRNGKey(seed), cfg,
                                        embeddings, device),
                   device=device, mesh=mesh)

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
                    obj_feats=obj, train=False, lengths=lengths, tp=self.tp)
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
        microbatch draws the next stretch of the step's dropout stream.

        On the card the phase markers (:meth:`_mark`) go onto the stream,
        and into a captured graph: ``forward`` and ``backward`` before
        each microbatch's forward and backward, ``update`` before the
        collectives, clip and Adam, ``end`` after the update.

        Under a dp mesh the losses are the rank's shares, the dropout
        masks the rank's rows of the global batch's (``RankRows``), the
        metrics are summed over the group, and the flat gradient is
        all-reduced (or, under ZeRO-1, reduce-scattered) before the
        clip."""
        mesh = self.mesh
        A = self.tc.accum_steps
        trainable = self.trainable_params()
        if mesh is not None:
            generator = RankRows(generator, mesh.size, mesh.rank)
        for p in trainable:
            p.grad = None
        metrics = None
        for tok, ob, lens in self._microbatches(tokens, obj, lengths):
            self._mark("forward")
            total, m = compute_losses(
                self.cfg, self.tc, self.params, tok, neg, obj_feats=ob,
                generator=generator, train=True, lengths=lens, mesh=mesh,
                tp=self.tp)
            self._mark("backward")
            total.backward()
            m = {k: v.detach() for k, v in m.items()}
            metrics = m if metrics is None else {
                k: metrics[k] + m[k] for k in m}
        self._mark("update")
        grads = [torch.zeros_like(p) if p.grad is None else p.grad
                 for p in trainable]
        if mesh is not None:
            # the global losses: one all-reduce of every metric
            vals = all_reduce_(torch.stack(list(metrics.values())), mesh)
            metrics = dict(zip(metrics, vals.unbind()))
        if A > 1:
            metrics = {k: v / A for k, v in metrics.items()}
        if self.zero1 is not None:
            self.zero1.step(grads, A, self.tc.grad_clip)
            self._mark("end")
            return metrics
        if mesh is not None:
            grads = all_reduce_flat(grads, mesh)
        if A > 1:
            grads = [g / A for g in grads]
        # the cut parameters' flags and the mp group only under tensor
        # parallelism: the clip is called as (grads, max_norm) otherwise
        mp_kw = ({} if self._mp() == 1
                 else {"cut": self._trainable_cut(), "mesh": mesh})
        clipped, _ = clip_by_global_norm(grads, self.tc.grad_clip, **mp_kw)
        for p, g in zip(trainable, clipped):
            p.grad = g
        self.optimizer.step()
        self._mark("end")
        return metrics

    def _mark(self, phase: str) -> None:
        """Launch the empty kernel ``cliora_mark_<phase>`` on the current
        stream (ops/span_region.py:phase_marker), so that a device trace
        puts a step's kernels down to its phases; nothing on the CPU or
        while the tracing registry is off."""
        if obs.TRACING and self.device.type == "cuda":
            phase_marker(phase, self.device)

    def _microbatches(self, tokens, obj, lengths):
        """``(tokens, obj, lengths)`` of each of the ``accum_steps``
        microbatches.  Under a dp mesh with A > 1 microbatch i is rows
        ``[i*B/A, (i+1)*B/A)`` of the global batch (B rows over the
        group), as the JAX dp step slices it, and the rank takes its
        block of those rows: the rows are gathered from the group first
        (no gradient flows into the inputs)."""
        A = self.tc.accum_steps
        size, rank = 1, 0
        if self.mesh is not None and A > 1:
            size, rank = self.mesh.size, self.mesh.rank
            tokens, obj, lengths = (
                None if x is None else all_gather_rows(x, self.mesh)
                for x in (tokens, obj, lengths))
        B = tokens.shape[0]
        if B % (A * size):
            raise ValueError(f"batch {B} not divisible by accum_steps {A}"
                             + (f" x {size} ranks" if size > 1 else ""))
        m = B // (A * size)
        out = []
        for i in range(A):
            part = slice(i * B // A + rank * m, i * B // A + (rank + 1) * m)
            out.append((tokens[part], None if obj is None else obj[part],
                        None if lengths is None else lengths[part]))
        return out

    def _graph_key(self, batch) -> tuple:
        """The shapes a captured step is specialised to: B, L, k_neg, R,
        F (None without regions), ``lengths`` given or not,
        ``accum_steps``, the dp group's size, the mp group's and
        ``zero1``."""
        tokens, neg, obj, lengths = batch
        return (*tokens.shape, neg.shape[0],
                *((None, None) if obj is None else obj.shape[1:]),
                lengths is not None, self.tc.accum_steps,
                dp_size(self.mesh), self._mp(), self.tc.zero1)

    def steps(self, batch_maps) -> List[Dict[str, torch.Tensor]]:
        """``len(batch_maps)`` train steps on batches of one shape, which
        leave exactly the state of as many ``step`` calls.  Returns one
        dict of device-resident scalars per step, with no host sync.

        On a CUDA trainer one train step (forward, backward, clip, Adam) is
        captured as a CUDA graph per shape key (:meth:`_graph_key`) and
        replayed for each batch: the batch is copied into the graph's
        static inputs and the dropout generator reseeded to the step's
        seed.  The first ``GRAPH_WARMUP_STEPS`` batches of a new shape run
        eagerly on a side stream before the capture.  The tracing
        registry's spans and counters follow each part: ``train.place``
        (the group's batches placed on the device), ``train.eager`` and
        ``train.eager_steps`` (an eager step, the CPU's every step),
        ``train.captures`` (the capture's seconds are
        ``capture_seconds``), and a replay's spans
        (:meth:`_StepGraph.replay`) and ``train.replays``.  A capture
        that fails raises; no eager step runs in its place.  On the CPU
        the steps run eagerly.  Under a dp mesh the collectives are
        captured too, which takes NCCL: a CUDA trainer in a gloo group
        raises here (its eager ``step`` works).  (reference:
        cliora_tpu/training/trainer.py:670-707 ``steps``, :425-448
        ``multi_step``)
        """
        if not batch_maps:
            raise ValueError("steps needs at least one batch")
        if (self.device.type == "cuda" and self.mesh is not None
                and self.mesh.backend != "nccl"):
            raise RuntimeError(
                f"Trainer.steps on the card captures the dp collectives in "
                f"a CUDA graph, which takes NCCL; this group runs "
                f"{self.mesh.backend!r}: use Trainer.step")
        with obs.span("train.place"):
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
                with obs.span("train.eager"):
                    out.append(self._train_step(
                        *batch, self.dropout_generator(self._host_step)))
                obs.count("train.eager_steps")
            self._host_step += 1
        return out

    def _graphed_step(self, key, batch):
        graph = self._graphs.get(key)
        if graph is None:
            warmed = self._warmed.get(key, 0)
            if warmed < GRAPH_WARMUP_STEPS:
                self._warmed[key] = warmed + 1
                with obs.span("train.eager"):
                    metrics = self._side_stream_step(batch)
                obs.count("train.eager_steps")
                return metrics
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
            obs.count("train.captures")
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

    def trainable_params(self) -> List[torch.Tensor]:
        """The trainable parameters, in :meth:`_trainable`'s order."""
        return [p for _, p in self._trainable()]

    def _mp(self) -> int:
        return 1 if self.mesh is None else self.mesh.mp

    def _trainable_cut(self) -> List[bool]:
        """Whether each trainable parameter is the rank's slice of a cut
        one, in :meth:`_trainable`'s order."""
        return [self._dim_of[k] is not None for k, _ in self._trainable()]

    def _whole(self, path: str, t: torch.Tensor) -> torch.Tensor:
        """The whole tensor of a leaf's (or its Adam moment's) slice: an
        all-gather over the mp group for a cut leaf."""
        d = self._dim_of[path]
        return t if d is None else gather_mp(t, self.mesh, d)

    def full_params(self):
        """The whole parameters: ``self.params`` itself, or under tensor
        parallelism a new tree gathered from the mp group's slices (a
        collective: every rank calls it).  Checkpoints are written from
        it."""
        if self._mp() == 1:
            return self.params
        return gather_params(self.mesh, self.params, self.shard_dims)

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
        with the device.  Under ZeRO-1 or tensor parallelism every rank
        must call it: it gathers the shards into whole moments
        (cliora_tpu/training/trainer.py ``local_opt_state``)."""
        def host(path, t):  # a copy: the next step updates ``t`` in place
            return self._whole(path, t.detach()).to(
                "cpu", copy=True).numpy()

        out = {"count": 0, "mu": {}, "nu": {}}
        if self.zero1 is not None:
            count, mu, nu = self.zero1.full_state()
            out["count"] = count
            for (path, p), m, v in zip(self._trainable(), mu, nu):
                out["mu"][path] = host(path, m.view(p.shape))
                out["nu"][path] = host(path, v.view(p.shape))
            return out
        for path, p in self._trainable():
            st = self.optimizer.state[p]
            out["count"] = int(st["step"])
            out["mu"][path] = host(path, st["exp_avg"])
            out["nu"][path] = host(path, st["exp_avg_sq"])
        return out

    @torch.no_grad()
    def install_state(self, params=None, opt_state=None):
        """Write loaded parameters (a tree shaped like ``self.params``, of
        tensors or arrays) and optimizer state (the form of
        :meth:`opt_state`; its count becomes every parameter's Adam step)
        into this trainer's tensors with ``copy_``.  Nothing is rebound,
        so captured graphs stay valid (cliora_tpu/training/trainer.py:
        531-559 ``install_state``).  Under a dp mesh every rank must
        call it: the parameters are then rank 0's, and ZeRO-1 keeps the
        rank's slice of the optimizer state.  The values are whole
        tensors; under tensor parallelism each rank keeps its slices (the
        JAX ``install_state`` re-shards).  Raises ``ValueError`` on a
        missing path or a shape that differs."""
        def local(src, path, what):
            """``src``, checked against the whole shape, as the rank's
            slice."""
            src = torch.as_tensor(src)
            if tuple(src.shape) != self.full_shapes[path]:
                raise ValueError(f"{what}: shape {tuple(src.shape)} != "
                                 f"{self.full_shapes[path]}")
            d = self._dim_of[path]
            return src if d is None else mp_slice(src, self.mesh, d)

        def put(dst, src, path, what):
            dst.copy_(local(src, path, what))

        if params is not None:
            flat = dict(zip(tree_paths(params), tree_leaves(params)))
            for path, p in zip(tree_paths(self.params),
                               tree_leaves(self.params)):
                if path not in flat:
                    raise ValueError(f"params: no {path}")
                put(p, flat[path], path, path)
            replicate_tree(self.mesh, tree_leaves(self.params))
            if self.zero1 is not None:
                self.zero1.params_changed()
        if opt_state is not None:
            trainable = self._trainable()
            names = {k for k, _ in trainable}
            for part in ("mu", "nu"):
                if set(opt_state[part]) != names:
                    raise ValueError(
                        f"opt_state {part}: paths "
                        f"{sorted(set(opt_state[part]) ^ names)} do not "
                        f"match the trainable parameters")
            if self.zero1 is not None:
                mine = {part: [local(opt_state[part][k], k, f"{part}/{k}")
                               for k, _ in trainable]
                        for part in ("mu", "nu")}
                self.zero1.install(int(opt_state["count"]), mine["mu"],
                                   mine["nu"])
                return
            for path, p in trainable:
                st = self.optimizer.state[p]
                put(st["exp_avg"], opt_state["mu"][path], path, "mu/" + path)
                put(st["exp_avg_sq"], opt_state["nu"][path], path,
                    "nu/" + path)
                st["step"].fill_(float(opt_state["count"]))
            replicate_tree(self.mesh, [
                self.optimizer.state[p][k] for _, p in trainable
                for k in ("exp_avg", "exp_avg_sq")])

    def parameter_norm(self, trainable_only: bool = True) -> float:
        """Sum of per-parameter L2 norms (reference: trainer.py:360-367);
        under tensor parallelism a collective over the mp group."""
        total = 0.0
        for p, m in zip(tree_leaves(self.full_params()),
                        tree_leaves(self.mask)):
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
        if self._mp() > 1:
            # K1 reads whole compose weights: under tensor parallelism the
            # parse takes the plain route, as the JAX package's mp gating
            # does (cliora_tpu/training/trainer.py:736-740)
            impl = "plain"
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
        (kernel K1) or "plain" (the chart pass).  Under tensor
        parallelism the mp ranks of a dp row parse the same rows together
        (a collective) on the plain route.  ``metrics`` maps each
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

        The tracing registry's spans follow a request on either route:
        ``parse.route``, ``parse.upload`` (the batch to the device),
        ``parse.forward`` (the launches of the forward and decode) and
        ``parse.copy_back`` (the copy to the host, which waits for the
        device); the counter ``parse.route.<route>`` counts requests.
        """
        with obs.span("parse.route"):
            route = self._route(impl, batch_map, compute_loss, with_chart,
                                outside)
        obs.count("parse.route." + route)
        if route == "cuda":
            with obs.span("parse.upload"):
                tokens = torch.as_tensor(np.asarray(batch_map["sentences"]),
                                         dtype=torch.int64).to(self.device)
            with obs.span("parse.forward"):
                dp = self.params["diora"]
                h0, _ = leaf_transform(
                    self.cfg, dp, embed_span(self.params["embed"], tokens))
                _, bp, _ = inside_cky.fused_inside_cky(
                    dp, h0, norm=self.cfg.normalize,
                    compute_dtype=self.cfg.compute_dtype)
            with obs.span("parse.copy_back"):
                bp = bp.cpu().numpy()
            return {"cky_bp": bp, "parse_impl": route}, {}

        if outside is None:
            outside = self.cfg.use_obj
        if compute_loss:
            outside = True
        with obs.span("parse.upload"):
            if batch_map.get("neg_samples") is None:
                batch_map = {**batch_map,
                             "neg_samples": np.zeros(1, np.int64)}
            tokens, neg, obj, lengths = self._place_batch(batch_map)
        if self.cfg.arch == "word":
            # chart-free baseline: no trees, grounding scores only
            with obs.span("parse.forward"):
                wg, metrics = word_grounding_losses(
                    self.cfg, self.tc, self.params, tokens, obj,
                    lengths=lengths, tp=self.tp)
            with obs.span("parse.copy_back"):
                res = {"atten_score": wg.atten_score.cpu().numpy(),
                       "parse_impl": route}
                metrics = ({k: float(v) for k, v in metrics.items()}
                           if compute_loss else {})
            return res, metrics
        with obs.span("parse.forward"):
            out, aux = forward_outputs(
                self.cfg, self.tc, self.params, tokens, obj_feats=obj,
                train=False, with_cky=True, outside=outside, lengths=lengths,
                tp=self.tp)
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
                                      neg, out, aux, lengths=lengths,
                                      tp=self.tp)
        with obs.span("parse.copy_back"):
            res = {k: (v.float() if v.is_floating_point() else v).cpu()
                   .numpy() for k, v in res.items()}
            metrics = {k: float(v) for k, v in metrics.items()}
        res["parse_impl"] = route
        return res, metrics
