"""Sealed parse artifacts for serving: ``torch.export`` bundles.

Counterpart of cliora_tpu/serving.py.  A bundle is a directory of
per-bucket programs (one per padded sentence length) written with
``torch.export.save``, plus a ``manifest.json``; the loader pads each
request to its bucket, masks by true length (the traced ``lengths`` of
padded length buckets), and decodes trees on the host.

Weights travel one of two ways (``export_parser(params_in_args=...)``):
as the programs' first input, a flat ``{path: tensor}`` dict with a
``params.npz`` sidecar the loader uploads to the device once, or baked
into every program as constants.

The batch dimension is exported symbolically (``torch.export.Dim``), so
one program serves any batch size.  On the card :meth:`ExportedParser.
warmup` captures one CUDA graph per (bucket, quantized row count), the
counterpart of the JAX bundle's per-shape executable, and every later
call of that shape replays it.  A CUDA graph lives in its process only:
a restarted server loads the programs and captures again (the JAX
loader's ``cache=True`` and its ``xla_cache`` have no counterpart).

:class:`ExportedParser` imports nothing of the port's ``models``,
``ops``, ``training`` or ``chart``: the program is the model.  Exporting
(:func:`export_parser`) does.
"""

from __future__ import annotations

import io
import json
import os
import threading
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

MANIFEST = "manifest.json"
FORMAT = "cliora_tpu_torch.export.v1"
# the devices a program may run on, stored in each .pt2 beside the program
# (as a JAX artifact carries its lowering platforms)
_PLATFORMS_FILE = "platforms"


def _default_device() -> torch.device:
    """The card; raises without one (training/trainer.py:_default_device,
    repeated so that the loader imports nothing of ``training``)."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on the GPU unless the caller "
            "asks for the CPU (device='cpu')")
    return torch.device("cuda")


def _nest(flat: Dict[str, torch.Tensor]) -> dict:
    """``{"a/b/c": x}`` -> the nested parameter tree."""
    tree: dict = {}
    for key, x in flat.items():
        *parents, leaf = key.split("/")
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = x
    return tree


class ParseModule(torch.nn.Module):
    """The length-masked parse (cliora_tpu/serving.py:_parse_fn).

    With ``params`` (a nested dict of tensors) the weights are the
    module's own and become the exported program's constants; with
    ``params=None`` ``forward`` takes a flat ``{path: tensor}`` dict of
    weights (``training/checkpoint.py:flatten`` keys) as its first input.

    ``forward(tokens, lengths[, obj_feats])`` returns ``{"cky_bp": (B,
    ncells) int32}`` (+ ``atten_score`` (B, L, R) for CLIORA).  It keeps
    ``Trainer.parse``'s eval semantics: the outside pass runs only when
    the visual head needs it, and the span x region scores go the
    ``chunked`` way (``TrainConfig(attn_impl="chunked")``).
    """

    def __init__(self, cfg, params=None):
        super().__init__()
        from cliora_tpu_torch.training.trainer import (
            TrainConfig,
            forward_outputs,
        )

        self.cfg = cfg
        self.tc = TrainConfig(attn_impl="chunked")
        self.params = params
        self._forward_outputs = forward_outputs

    def forward(self, *args):
        if self.params is None:
            flat, *args = args
            params = _nest(flat)
        else:
            params = self.params
        tokens, lengths, *obj = args
        out, _ = self._forward_outputs(
            self.cfg, self.tc, params, tokens,
            obj_feats=obj[0] if obj else None, train=False, with_cky=True,
            outside=self.cfg.use_obj, lengths=lengths)
        res = {"cky_bp": out.chart.cky_bp}
        if self.cfg.use_obj:
            res["atten_score"] = out.atten_score
        return res


def _example_inputs(cfg, L: int, b: int, device):
    """Zero tokens and full lengths of ``b`` rows of length ``L`` (+ zero
    region features for CLIORA)."""
    args = [torch.zeros((b, L), dtype=torch.int64, device=device),
            torch.full((b,), L, dtype=torch.int64, device=device)]
    if cfg.use_obj:
        args.append(torch.zeros((b, cfg.n_regions, cfg.obj_feat_size),
                                dtype=torch.float32, device=device))
    return args


def export_parser(cfg, params, bucket_lengths: Sequence[int], *,
                  platforms: Optional[Sequence[str]] = None,
                  batch: Optional[int] = None,
                  params_in_args: bool = False) -> Dict[int, bytes]:
    """One saved ``torch.export`` program per padded sentence length.

    ``params`` is the nested parameter tree (``Trainer.params``).
    ``batch=None`` exports a symbolic batch dimension; an int pins it.
    ``platforms`` names torch devices (``"cuda"``, ``"cpu"``): the program
    is exported on the first, and the loader may move it to any other
    listed one; default the card (raises without one).
    ``params_in_args=True`` makes the weights the programs' first input:
    pass the same ``params`` to :func:`save_bundle` for the ``params.npz``
    sidecar.  Returns ``{L: bytes}``, each what ``torch.export.save``
    writes.
    """
    from cliora_tpu_torch.chart.indices import INDEX
    from cliora_tpu_torch.training.checkpoint import flatten

    if cfg.arch != "mlp":
        # the programs parse padded buckets, which the JAX package's
        # chart pass takes for the mlp arch only, and the word baseline
        # has no chart to parse (cliora_tpu/serving.py:66-75 fails there)
        raise ValueError(f"arch={cfg.arch!r}: a bundle serves the mlp "
                         "chart only (padded buckets support the mlp arch "
                         "only; the word baseline parses no trees)")
    platforms = [str(p) for p in platforms] if platforms else ["cuda"]
    for p in platforms:
        if p not in ("cuda", "cpu"):
            raise ValueError(f"platform {p!r}: expected 'cuda' or 'cpu'")
    device = (_default_device() if platforms[0] == "cuda"
              else torch.device("cpu"))
    flat = {k: torch.from_numpy(v).to(device)
            for k, v in flatten(params).items()}
    module = ParseModule(cfg, None if params_in_args else _nest(flat))
    # min=1: without it torch.export treats a batch of 1 as a special case
    b = torch.export.Dim("b", min=1) if batch is None else None
    example_rows = 2 if batch is None else int(batch)

    out = {}
    for L in sorted(set(int(x) for x in bucket_lengths)):
        if L < 2:
            raise ValueError(f"bucket length {L} has no binary tree")
        args = _example_inputs(cfg, L, example_rows, device)
        # the chart index tensors of this length, made before the trace
        # so that the program holds real ones (chart/indices.py)
        INDEX.fill(L, args[0].device)
        dynamic = [{0: b} for _ in args]
        if params_in_args:
            args.insert(0, flat)
            dynamic.insert(0, {k: {} for k in flat})
        with torch.no_grad():
            program = torch.export.export(
                module, tuple(args),
                # one entry: forward takes its inputs as *args
                dynamic_shapes=None if b is None else (tuple(dynamic),),
                strict=False)
        # the example inputs would be saved too: in the weights-as-inputs
        # mode a copy of the weights in every file
        program.example_inputs = None
        buf = io.BytesIO()
        torch.export.save(program, buf,
                          extra_files={_PLATFORMS_FILE: ",".join(platforms)})
        out[L] = buf.getvalue()
    return out


def save_bundle(path: str, cfg, artifacts: Dict[int, bytes], *,
                word2idx: Optional[dict] = None,
                batch: Optional[int] = None,
                params=None,
                extra_meta: Optional[dict] = None) -> None:
    """Write a serving bundle: per-bucket programs + manifest (+ vocab).

    ``batch`` must echo export_parser's ``batch`` (None = symbolic);
    ``params`` must be given exactly when the programs were exported with
    ``params_in_args=True``: the weights then land in ``params.npz``
    (flat ``/``-joined keys, training/checkpoint.py conventions).
    """
    os.makedirs(path, exist_ok=True)
    files = {}
    for L, blob in artifacts.items():
        name = f"parse_L{L}.pt2"
        with open(os.path.join(path, name), "wb") as f:
            f.write(blob)
        files[str(L)] = name
    if params is not None:
        from cliora_tpu_torch.training.checkpoint import flatten

        np.savez(os.path.join(path, "params.npz"), **flatten(params))
    meta = {
        "format": FORMAT,
        "torch_version": torch.__version__,
        "bucket_lengths": sorted(artifacts),
        "files": files,
        "batch": int(batch) if batch else None,
        "params_in_args": params is not None,
        "use_obj": cfg.use_obj,
        "n_regions": cfg.n_regions if cfg.use_obj else None,
        "obj_feat_size": cfg.obj_feat_size if cfg.use_obj else None,
    }
    if extra_meta:
        meta.update(extra_meta)
    with open(os.path.join(path, MANIFEST), "w") as f:
        json.dump(meta, f, indent=2)
    if word2idx is not None:
        with open(os.path.join(path, "vocab.json"), "w") as f:
            json.dump(word2idx, f)


def _pow2_rows(n: int) -> int:
    """Smallest power of two >= n (batch-shape quantization)."""
    return 1 << max(0, n - 1).bit_length()


class _ShapeGraph:
    """One program call captured as a CUDA graph at one (bucket, rows)
    shape, with the static inputs each replay copies its request into."""

    def __init__(self, fn, params, inputs, pool):
        self.inputs = inputs
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph, pool=pool):
            self.out = fn(*params, *inputs)

    def replay(self, host_inputs) -> Dict[str, np.ndarray]:
        for dst, src in zip(self.inputs, host_inputs):
            dst.copy_(torch.from_numpy(src))
        self.graph.replay()
        # copied out before the next replay overwrites them
        return {k: v.cpu().numpy() for k, v in self.out.items()}


class ExportedParser:
    """Serve parses from a bundle -- no model code.

    ``parse`` takes ragged token-id sequences, groups them by the
    smallest covering bucket, pads (ids beyond the true length are
    ignored by the length mask), runs the program, and returns one binary
    tree per sentence as nested (start, end) span tuples
    (analysis/trees.py ``decode_batch``).

    ``device=None`` is the card, and raises without one.  On the card,
    :meth:`warmup` captures a CUDA graph per shape; ``graph_replays`` and
    ``eager_calls`` count the program calls each route served.  One lock
    holds every device call (capture, replay, eager call), so a warm-up
    thread and request threads never interleave on the device.
    """

    def __init__(self, path: str, device=None):
        with open(os.path.join(path, MANIFEST)) as f:
            self.meta = json.load(f)
        if self.meta.get("format") != FORMAT:
            raise ValueError(f"{path}: not a {FORMAT} bundle: "
                             f"{self.meta.get('format')!r}")
        self.device = (_default_device() if device is None
                       else torch.device(device))
        self._fns = {}
        for L, name in self.meta["files"].items():
            extra = {_PLATFORMS_FILE: ""}
            program = torch.export.load(os.path.join(path, name),
                                        extra_files=extra)
            platforms = extra[_PLATFORMS_FILE].split(",")
            if self.device.type not in platforms:
                raise ValueError(
                    f"{name} was exported for {platforms}, not for "
                    f"{self.device.type!r}")
            if platforms[0] != self.device.type:
                from torch.export.passes import move_to_device_pass

                program = move_to_device_pass(program, self.device)
            self._fns[int(L)] = program.module()
        self.bucket_lengths = sorted(self._fns)
        # weights-as-inputs bundle: uploaded once; every call passes the
        # same device tensors
        self._params = ()
        if self.meta.get("params_in_args"):
            with np.load(os.path.join(path, "params.npz"),
                         allow_pickle=False) as z:
                self._params = ({k: torch.from_numpy(z[k]).to(self.device)
                                 for k in z.files},)
        vocab_path = os.path.join(path, "vocab.json")
        self.word2idx = None
        if os.path.exists(vocab_path):
            with open(vocab_path) as f:
                self.word2idx = json.load(f)
        self._lock = threading.Lock()
        self._graphs: Dict[tuple, _ShapeGraph] = {}
        self._pool = None
        self.capture_seconds: Dict[tuple, float] = {}
        self.graph_replays = 0
        self.eager_calls = 0

    def bucket_for(self, n: int) -> int:
        for L in self.bucket_lengths:
            if L >= n:
                return L
        raise ValueError(
            f"sentence length {n} exceeds the largest exported bucket "
            f"{self.bucket_lengths[-1]}")

    def _sizes(self, max_batch: int) -> List[int]:
        pin = self.meta.get("batch")
        if pin:
            return [int(pin)]
        sizes, b = [], 1
        cap = _pow2_rows(max(1, int(max_batch)))
        while b <= cap:
            sizes.append(b)
            b <<= 1
        return sizes

    def _host_inputs(self, L: int, b: int):
        """Length-``L`` rows of ones, as :meth:`parse` would pad them."""
        args = [np.ones((b, L), np.int64), np.full((b,), L, np.int64)]
        if self.meta["use_obj"]:
            args.append(np.zeros((b, self.meta["n_regions"],
                                  self.meta["obj_feat_size"]), np.float32))
        return args

    def warmup(self, max_batch: int = 64) -> int:
        """Make every (bucket, quantized-batch) shape warm.

        ``max_batch`` is a row (sentence) count: afterwards every program
        call of up to ``max_batch`` rows is warm.  Callers that coalesce
        requests must bound the coalesced rows to ``max_batch``
        (MicroBatcher does; pass ``max_rows=max_batch`` to :meth:`parse`
        for direct calls).  On the card each shape's call is captured as
        a CUDA graph, all in one memory pool; on the CPU each shape runs
        once.  A capture that fails raises.  Returns the number of shapes
        (buckets x quantized sizes).
        """
        n = 0
        for L in self.bucket_lengths:
            for b in self._sizes(max_batch):
                if self.device.type == "cuda":
                    with self._lock:
                        if (L, b) not in self._graphs:
                            self._capture(L, b)
                else:
                    self._call(L, self._host_inputs(L, b))
                n += 1
        return n

    def _capture(self, L: int, b: int):
        """Capture the bucket-``L`` program at ``b`` rows (lock held).

        The static inputs, like the weights, are allocated outside the
        graphs' shared pool; one eager call on a side stream comes first,
        as PyTorch's whole-network capture warms up.  The pool is sound
        to share because replays run one at a time under the lock and
        each replay's outputs are copied out before the next."""
        fn = self._fns[L]
        inputs = [torch.from_numpy(a).to(self.device)
                  for a in self._host_inputs(L, b)]
        t0 = time.perf_counter()
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side), torch.no_grad():
            fn(*self._params, *inputs)
        torch.cuda.current_stream(self.device).wait_stream(side)
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        try:
            with torch.no_grad():
                graph = _ShapeGraph(fn, self._params, inputs, self._pool)
        except RuntimeError as err:
            # the failed capture leaves its pool marked as capturing:
            # later captures start a pool of their own
            self._pool = None
            raise RuntimeError(
                f"CUDA graph capture of bucket {L} at {b} rows failed"
            ) from err
        self._graphs[(L, b)] = graph
        self.capture_seconds[(L, b)] = time.perf_counter() - t0

    def warmup_async(self, max_batch: int = 64):
        """:meth:`warmup` on a daemon thread; returns the Thread.

        A server can accept requests at once: a request of a shape not yet
        warm runs the program eagerly.  The parser's lock keeps each
        capture apart from the request threads' device calls (a capture
        would otherwise record, or be broken by, another thread's work on
        the device).  Join the thread to know when every shape is warm.
        """
        t = threading.Thread(target=self.warmup, args=(max_batch,),
                             daemon=True)
        t.start()
        return t

    def _call(self, L: int, host_inputs) -> Dict[str, np.ndarray]:
        """The bucket-``L`` program on host arrays: a graph replay where
        the shape is captured, else an eager call."""
        b = host_inputs[0].shape[0]
        with self._lock:
            graph = self._graphs.get((L, b))
            if graph is not None:
                self.graph_replays += 1
                return graph.replay(host_inputs)
            self.eager_calls += 1
            with torch.no_grad():
                out = self._fns[L](*self._params, *(
                    torch.from_numpy(a).to(self.device)
                    for a in host_inputs))
            return {k: v.cpu().numpy() for k, v in out.items()}

    def parse(self, sentences: List[Sequence[int]],
              obj_feats: Optional[np.ndarray] = None,
              max_rows: Optional[int] = None):
        """Token-id sequences -> span trees (+ per-word region argmax
        for CLIORA bundles when ``obj_feats`` (B, R, F) is given).

        ``max_rows`` caps the rows per program call (oversized bucket
        groups are chunked), so a caller that warmed up to N rows keeps
        every call warm by passing ``max_rows=N``."""
        from cliora_tpu_torch.analysis.trees import decode_batch

        if not sentences:
            raise ValueError("no sentences")
        if not all(len(s) >= 1 for s in sentences):
            raise ValueError("empty sentence")
        use_obj = bool(self.meta["use_obj"])
        if use_obj and obj_feats is None:
            raise ValueError("CLIORA bundle needs obj_feats")
        order = sorted(range(len(sentences)),
                       key=lambda i: self.bucket_for(len(sentences[i])))
        pin = self.meta.get("batch")  # int = pinned batch dim export
        trees: dict = {}
        attn: dict = {}
        i = 0
        while i < len(order):
            L = self.bucket_for(len(sentences[order[i]]))
            group = [j for j in order[i:]
                     if self.bucket_for(len(sentences[j])) == L]
            i += len(group)
            # pinned-batch programs take exactly `pin` rows: chunk the
            # group and pad the tail with length-1 dummy rows (their
            # outputs are discarded); max_rows chunks symbolic-batch
            # groups so warmed callers never leave the captured shapes
            step = pin or (max_rows if max_rows else len(group))
            for c0 in range(0, len(group), step):
                chunk = group[c0:c0 + step]
                # the padded row count is quantized to the next power of
                # two, so at most log2(B) shapes per bucket need a graph
                nrow = pin or _pow2_rows(len(chunk))
                toks = np.zeros((nrow, L), np.int64)
                lens = np.ones((nrow,), np.int64)
                for r, j in enumerate(chunk):
                    lens[r] = len(sentences[j])
                    toks[r, :lens[r]] = np.asarray(sentences[j], np.int64)
                args = [toks, lens]
                if use_obj:
                    of = np.zeros(
                        (nrow,) + tuple(np.shape(obj_feats)[1:]),
                        np.float32)
                    of[:len(chunk)] = np.asarray(obj_feats[chunk],
                                                 np.float32)
                    args.append(of)
                res = self._call(L, args)
                bp = res["cky_bp"][:len(chunk)]
                decoded = decode_batch(bp, L, lens[:len(chunk)])
                for r, j in enumerate(chunk):
                    trees[j] = decoded[r][0]
                    if use_obj:
                        attn[j] = res["atten_score"][r, :lens[r]].argmax(-1)
        out_trees = [trees[j] for j in range(len(sentences))]
        if use_obj:
            return out_trees, [attn[j] for j in range(len(sentences))]
        return out_trees

    def tokenize(self, sentences: List[str], *, unk: str = "<unk>"):
        """Whitespace sentences -> (token-id lists, word lists); unknown
        words map to the bundle vocab's ``unk`` entry (the readers' UNK
        convention, data/preprocessing.py)."""
        if self.word2idx is None:
            raise ValueError("bundle has no vocab.json; send token ids")
        unk_id = self.word2idx.get(unk, 0)
        words = [s.split() for s in sentences]
        toks = [[self.word2idx.get(w, unk_id) for w in ws]
                for ws in words]
        return toks, words

    def parse_text(self, sentences: List[str], *, unk: str = "<unk>",
                   obj_feats: Optional[np.ndarray] = None):
        """Whitespace-tokenized sentences -> trees with word leaves
        (needs the bundle's ``vocab.json``)."""
        from cliora_tpu_torch.analysis.trees import replace_leaves

        toks, _ = self.tokenize(sentences, unk=unk)
        out = self.parse(toks, obj_feats=obj_feats)
        trees = out[0] if self.meta["use_obj"] else out
        worded = [replace_leaves(t, s.split())
                  for t, s in zip(trees, sentences)]
        if self.meta["use_obj"]:
            return worded, out[1]
        return worded


class MicroBatcher:
    """Coalesce concurrent parse requests into one device call
    (cliora_tpu/serving.py:MicroBatcher, copied).

    HTTP handlers call :meth:`submit` from their own threads; a single
    dispatcher thread drains the queue, concatenates all pending
    sentence lists, runs ONE ``parser.parse`` over the union, and
    scatters the trees back.

    ``max_wait_ms`` bounds the added latency for the request that opens
    a batch; ``max_batch`` bounds the total number of *sentences (rows)*
    coalesced per device call -- the same unit as
    ``ExportedParser.warmup(max_batch)``, so a server warmed to N rows
    never leaves its captured shapes (oversized single requests are
    chunked to ``max_batch`` rows per program call by ``parse``).
    """

    def __init__(self, parser, max_batch: int = 64,
                 max_wait_ms: float = 5.0):
        import queue

        self._parser = parser
        self._q: "queue.Queue" = queue.Queue()
        self._max_batch = max(1, int(max_batch))
        self._wait_s = max(0.0, float(max_wait_ms)) / 1e3
        self._holdover = None  # request deferred to the next batch
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    class _Req:
        __slots__ = ("sentences", "event", "result", "error")

        def __init__(self, sentences):
            self.sentences = sentences
            self.event = threading.Event()
            self.result = None
            self.error = None

    def submit(self, sentences):
        """Token-id sequences -> trees (blocks until the batch runs)."""
        req = self._Req(sentences)
        self._q.put(req)
        req.event.wait()
        if req.error is not None:
            raise req.error
        return req.result

    def close(self):
        """Stop the dispatcher thread (in-flight requests complete)."""
        self._q.put(None)
        self._thread.join(timeout=60)

    def _loop(self):
        import queue

        while True:
            if self._holdover is not None:
                first, self._holdover = self._holdover, None
            else:
                first = self._q.get()
            if first is None:  # close() sentinel
                return
            batch = [first]
            rows = len(first.sentences)
            # monotonic: a wall-clock step must not stretch the window
            deadline = time.monotonic() + self._wait_s
            stop = False
            while rows < self._max_batch:
                timeout = deadline - time.monotonic()
                try:
                    r = (self._q.get_nowait() if timeout <= 0
                         else self._q.get(timeout=timeout))
                except queue.Empty:
                    break
                if r is None:
                    stop = True
                    break
                if rows + len(r.sentences) > self._max_batch:
                    # would overflow the warmed row budget: it opens
                    # the next batch instead (queue has no push-front)
                    self._holdover = r
                    break
                batch.append(r)
                rows += len(r.sentences)
            try:
                flat = [s for r in batch for s in r.sentences]
                trees = self._parser.parse(flat, max_rows=self._max_batch)
                i = 0
                for r in batch:
                    r.result = trees[i:i + len(r.sentences)]
                    i += len(r.sentences)
            except Exception:
                # don't poison the whole batch with one bad request
                # (over-length sentence, empty list): retry each request
                # alone so only the offender fails
                for r in batch:
                    try:
                        r.result = self._parser.parse(
                            r.sentences, max_rows=self._max_batch)
                    except Exception as e:  # noqa: BLE001 -- per request
                        r.error = e
            for r in batch:
                r.event.set()
            if stop:
                return
