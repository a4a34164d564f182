"""Plain PyTorch inside / outside chart passes (counterpart of
cliora_tpu/ops/chart_pass.py).

One gather / compose / score / softmax / aggregate block per level over
the flat level-major ``(B, ncells, D)`` chart.  (reference:
cliora/net/diora.py:100-200,295-401 and cliora/net/cliora.py:103-208,
304-414; the CKY of cliora/analysis/cky.py:31-99 and the max-normalizing
hook of cliora/analysis/utils.py:78-95, fused on device.)

Both passes are differentiable: each level's outputs are new tensors,
and the chart a level reads is the concatenation of the levels below it
(a prefix of the flat chart, since the layout is level-major), so no
tensor autograd saved is ever written in place.  The inside pass is the
parse route for batches the fused kernel does not take (padded
``lengths``, hard aggregation, the TreeLSTM compose,
``parse_impl='plain'``, a CPU device) and the oracle of the whole chart;
with the outside pass it is the train step's chart.

The TreeLSTM arch carries a cell-state chart ``c`` beside the h chart,
gathered, aggregated with the same split and combo weights and
normalized the same way; the mlp arch has none.  With ``cfg.remat`` a
level's block runs under ``torch.utils.checkpoint``: its (B, rows, D)
intermediates are recomputed in the backward instead of stored
(:func:`remat_enabled`, :func:`_remat_level`, ``cfg.remat_policy``).

Tensor parallel (``mp``: the compose's ``fc0``/``fc1`` and the score
matrix cut on D over an mp group, parallel/sharding.py): the chart
stays whole on every rank, and only the gathered children's compose and
score are sharded work, each ending in one all-reduce.  Where a child's
gradient comes back from that work it is a partial sum on each rank,
which must be all-reduced (``copy_to_mp``).  The mlp arch does that once
per chart level, on the level's output as the gathers read it, not on
the gathered pairs: at n = 20 the pairs are (n^3 - n)/6 = 1,330 rows of
2D a pass against 210 cells of D for the whole inside chart, and the
level's output feeds the sharded work through that copy only (its
replicated readers take the plain tensor).  The TreeLSTM's compose
stays replicated, so there the score's inputs alone are copied, per
pair.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import torch
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from cliora_tpu_torch.chart.indices import INDEX
from cliora_tpu_torch.chart.offsets import level_offsets, ncells
from cliora_tpu_torch.models.config import ModelConfig
from cliora_tpu_torch.ops.core import (
    bilinear,
    compose_mlp,
    compose_treelstm,
    dropout_keep,
    lowp_einsum,
    normalize,
    region_attention,
)
from cliora_tpu_torch.parallel.sharding import copy_to_mp

MASK_NEG = -1e9  # finite -inf stand-in: keeps masked-softmax grads NaN-free


class InsideOut(NamedTuple):
    inside_h: torch.Tensor              # (B, ncells, D) compute dtype
    inside_s: torch.Tensor              # (B, ncells, 1) f32
    inside_c: Optional[torch.Tensor]    # (B, ncells, D) | None (mlp arch)
    outside_h: Optional[torch.Tensor]   # (B, ncells, D) compute dtype
    outside_s: Optional[torch.Tensor]   # (B, ncells, 1) f32
    outside_c: Optional[torch.Tensor]
    cky_bp: Optional[torch.Tensor]      # (B, ncells) int32 argmax split
    cky_val: Optional[torch.Tensor]     # (B, ncells) f32 CKY values


def compute_dtype(cfg: ModelConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.compute_dtype == "bfloat16" else torch.float32


# Stored (rows, D) chart-dtype copies per gathered child row of an
# unremated train step, the factor of the "auto" estimate below: an
# eager bf16 CLIORA step's peak above the trainer over B*D*(n^3-n)/2
# chart bytes, measured on an H100 by tools/mem_analysis.py at (B, n) =
# (128, 20), (64, 40), (128, 40): 8.79, 7.81, 7.73 (chip_smoke.py's
# ``remat`` phase read 8.63, 7.77, 7.70 on other batches; PERF.md section
# 6); the largest, rounded up.  (The JAX package's 5.6,
# cliora_tpu/ops/chart_pass.py:91, was measured on its own device.)
_ACT_COPY_FACTOR = 8.8


def remat_enabled(cfg: ModelConfig, B: int, n: int, D: int) -> bool:
    """Whether a (B, n) batch's chart levels are rematerialized.

    ``cfg.remat`` True/False force it.  "auto" estimates the step's
    stored-activation bytes, ``_ACT_COPY_FACTOR`` copies of the gathered
    children of both passes ((n^3 - n)/2 rows of D) in the chart dtype,
    and remats only past ``cfg.remat_budget_gb``: under mixed-length
    bucketing the short buckets keep full speed.
    (cliora_tpu/ops/chart_pass.py:94-114)
    """
    if cfg.remat is True:
        return True
    if not cfg.remat:
        return False
    return activation_estimate_bytes(cfg, B, n, D) > (
        cfg.remat_budget_gb * 2 ** 30)


def chart_bytes(cfg: ModelConfig, B: int, n: int, D: int) -> int:
    """Bytes of one chart-dtype copy of the gathered children of both
    passes of a (B, n) batch: (n^3 - n)/2 rows of D, inside (n^3-n)/6 and
    outside (n^3-n)/3."""
    itemsize = 2 if cfg.compute_dtype == "bfloat16" else 4
    return B * D * ((n ** 3 - n) // 2) * itemsize


def activation_estimate_bytes(cfg: ModelConfig, B: int, n: int,
                              D: int) -> float:
    """The "auto" estimate of an unremated step's stored activations:
    ``_ACT_COPY_FACTOR`` times :func:`chart_bytes`."""
    return _ACT_COPY_FACTOR * chart_bytes(cfg, B, n, D)


def _remat_level(cfg: ModelConfig, enabled: bool, cells: int,
                 peak_cells: int) -> bool:
    """Whether a level with ``(B, cells, D)`` intermediates is
    checkpointed, given the pass's largest level ``peak_cells`` (inside
    ``(n//2)(n - n//2)``, outside ``n(n-1)``): with ``remat_frac`` > 0
    only the levels within that fraction of the peak are.
    (cliora_tpu/ops/chart_pass.py:139-153)"""
    if not enabled:
        return False
    return cells >= cfg.remat_frac * peak_cells


class _ChildGathers:
    """True while a level gathers its chart children (the h-chart rows
    ``chart_h[:, idx]``), the ops the 'gathers' policy recomputes (the
    JAX package tags them ``CHILD_RESIDS``)."""
    active = False


def _take_children(chart: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    _ChildGathers.active = True
    try:
        return chart[:, idx]
    finally:
        _ChildGathers.active = False


_MATMULS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
            torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    """'dots': keep the outputs of matrix products (the compose, bilinear
    and ``lowp_einsum`` products), recompute the rest
    (``jax.checkpoint_policies.dots_saveable``)."""
    return (CheckpointPolicy.MUST_SAVE if op in _MATMULS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _save_all_but_gathers(ctx, op, *args, **kwargs):
    """'gathers': keep everything but the chart-child gathers
    (``save_anything_except_these_names(CHILD_RESIDS)``)."""
    if op is torch.ops.aten.index.Tensor and _ChildGathers.active:
        return CheckpointPolicy.PREFER_RECOMPUTE
    return CheckpointPolicy.MUST_SAVE


_POLICIES = {"dots": _save_dots, "gathers": _save_all_but_gathers}


def _run_level(cfg: ModelConfig, remat: bool, fn, *args):
    """``fn(*args)``, under ``torch.utils.checkpoint`` with the configured
    policy when ``remat`` holds and autograd records.  No RNG state is
    stashed: a level draws no random numbers (its dropout mask comes in
    as an argument), and stashing the CUDA state would not be legal in a
    graph capture."""
    if not (remat and torch.is_grad_enabled()):
        return fn(*args)
    policy = _POLICIES.get(cfg.remat_policy)
    kw = {} if policy is None else {"context_fn": functools.partial(
        create_selective_checkpoint_contexts, policy)}
    return checkpoint(fn, *args, use_reentrant=False,
                      preserve_rng_state=False, **kw)


def _weighted_agg(pattern: str, h, p):
    """Softmax-weighted aggregation in the chart dtype: with bf16 charts
    ``dh`` comes back in bf16 and only ``dp`` accumulates f32
    (cliora_tpu/ops/chart_pass.py:156-168)."""
    return lowp_einsum(pattern, h, p, h.dtype, h.dtype)


def _aggregate_weights(cfg: ModelConfig, s, dim: int):
    if cfg.aggregate == "hard":
        # greedy (S-DIORA-style): best split only
        idx = torch.argmax(s, dim=dim, keepdim=True)
        return torch.zeros_like(s).scatter_(dim, idx, 1.0)
    return torch.softmax(s, dim=dim)


def _compose(cfg: ModelConfig, cp, lh, rh, lc, rc, mp=None):
    """``(h, c)`` of a compose: the TreeLSTM's f32 pair, or the mlp's h
    in the chart dtype and no c."""
    cdt = compute_dtype(cfg)
    if cfg.arch == "treelstm":
        return compose_treelstm(cp, (lh, lc), (rh, rc), compute_dtype=cdt)
    return compose_mlp(cp, lh, rh, compute_dtype=cdt, out_dtype=cdt,
                       mp=mp), None


def _copies_levels(cfg: ModelConfig, mp) -> bool:
    """Whether a pass marks each chart level with ``copy_to_mp`` (an mlp
    chart under tensor parallelism: every reader of the gathered children
    is sharded work), rather than each score's inputs."""
    return mp is not None and cfg.arch == "mlp"


def _score(cfg: ModelConfig, mat, left, right, mp):
    """The bilinear split scores of gathered children (B, rows) f32."""
    if mp is not None and not _copies_levels(cfg, mp):
        left, right = copy_to_mp(left, mp), copy_to_mp(right, mp)
    return bilinear(mat, left, right, compute_dtype=compute_dtype(cfg), mp=mp)


def inside_pass(cfg: ModelConfig, dp, h0: torch.Tensor,
                c0: Optional[torch.Tensor] = None, obj=None,
                generator: Optional[torch.Generator] = None,
                train: bool = False, with_cky: bool = False, mp=None):
    """Bottom-up pass.  ``h0``: (B, n, D) normalized leaf vectors; ``c0``:
    the TreeLSTM leaf cells (zero when ``None``); ``obj``: (B, R, D)
    region embeddings of a CLIORA model; ``mp``: the tensor-parallel mesh
    of the compose and score weights, or None.

    Returns ``(inside_h, inside_s, inside_c, cky_bp, cky_val)``: the h
    chart (B, ncells, D) in the compute dtype, scores (B, ncells, 1) f32,
    the TreeLSTM c chart (``None`` for mlp), and with ``with_cky`` the
    first-max backpointers (B, ncells) int32 and CKY values (B, ncells)
    f32 (``None`` otherwise).
    """
    B, n, D = h0.shape
    cdt = compute_dtype(cfg)
    dev = h0.device
    use_c = cfg.arch == "treelstm"
    if obj is not None:
        obj = obj.to(cdt)           # cast once, not per level

    # h (and c) chart in the compute dtype; scores and softmaxes stay f32
    hs = [h0.to(cdt)]
    # the chart as the children's gathers read it
    copies = _copies_levels(cfg, mp)
    hs_read = [copy_to_mp(hs[0], mp) if copies else hs[0]]
    ss = [torch.zeros((B, n), dtype=torch.float32, device=dev)]
    cs = None
    if use_c:
        cs = [(torch.zeros_like(h0) if c0 is None else c0).to(cdt)]
    vals = [torch.ones((B, n), dtype=torch.float32, device=dev)]
    bps = [torch.zeros((B, n), dtype=torch.int32, device=dev)]

    cp = dp["inside_compose"]
    mat = dp["inside_score"]["mat"]
    do_remat = remat_enabled(cfg, B, n, D)

    for level in range(1, n):
        L, N = n - level, level
        idx_l, idx_r = INDEX.inside(n, level, dev)

        def level_step(hs, ss, cs, obj, keep, idx_l=idx_l, idx_r=idx_r,
                       L=L, N=N):
            chart_h, chart_s = torch.cat(hs, 1), torch.cat(ss, 1)
            lh = _take_children(chart_h, idx_l)         # (B, L*N, D)
            rh = _take_children(chart_h, idx_r)
            lc = rc = None
            if use_c:
                chart_c = torch.cat(cs, 1)
                lc, rc = chart_c[:, idx_l], chart_c[:, idx_r]
            h, c = _compose(cfg, cp, lh, rh, lc, rc, mp)

            s_bil = _score(cfg, mat, lh, rh, mp)            # (B, L*N)
            s = (s_bil + chart_s[:, idx_l] + chart_s[:, idx_r]
                 ).reshape(B, L, N)
            p = _aggregate_weights(cfg, s, -1)          # over splits

            h_agg = _weighted_agg("blnd,bln->bld", h.reshape(B, L, N, D), p)
            s_agg = torch.sum(s * p, dim=-1)            # (B, L)
            h_agg = normalize(cfg.normalize, h_agg)
            if cfg.use_obj:
                # visual residual per level (reference: cliora.py:140-157)
                cxt = region_attention(
                    h_agg, obj, temp=cfg.attn_temp, dropout=cfg.attn_dropout,
                    train=train, compute_dtype=cdt, keep=keep)
                h_agg = normalize(cfg.normalize, h_agg + cxt)
            c_agg = None
            if use_c:
                c_agg = normalize(cfg.normalize, _weighted_agg(
                    "blnd,bln->bld", c.reshape(B, L, N, D), p))
            return h_agg, s_agg, c_agg, s

        # the level's dropout mask, drawn before the level so that a
        # recomputed level applies the same one
        keep = None
        if obj is not None and train and cfg.attn_dropout > 0.0:
            keep = dropout_keep(generator, (B, L, obj.shape[1]),
                                cfg.attn_dropout, dev)
        h_agg, s_agg, c_agg, s = _run_level(
            cfg, _remat_level(cfg, do_remat, L * N, (n // 2) * (n - n // 2)),
            level_step, tuple(hs_read), tuple(ss),
            None if cs is None else tuple(cs), obj, keep)
        hs.append(h_agg.to(cdt))
        hs_read.append(copy_to_mp(hs[-1], mp) if copies else hs[-1])
        ss.append(s_agg)
        if use_c:
            cs.append(c_agg.to(cdt))

        if with_cky:
            s_d = s.detach()
            chart_v = torch.cat(vals, 1)
            ps = (chart_v[:, idx_l] + chart_v[:, idx_r]).reshape(B, L, N) \
                + (s_d - torch.amax(s_d, dim=-1, keepdim=True))
            vals.append(torch.amax(ps, dim=-1))
            # torch.argmax returns the first maximal index: the
            # first-max tie rule of the JAX package
            bps.append(torch.argmax(ps, dim=-1).to(torch.int32))

    inside_h = torch.cat(hs, 1)
    inside_s = torch.cat(ss, 1)[..., None]
    inside_c = None if cs is None else torch.cat(cs, 1)
    if not with_cky:
        return inside_h, inside_s, inside_c, None, None
    return inside_h, inside_s, inside_c, torch.cat(bps, 1), torch.cat(vals, 1)


def _outside_masks(level: int, n: int, lengths: torch.Tensor):
    """Per-example validity masks at ``level`` for padded length buckets.

    ``combo_ok (B, N, L)``: the (parent, sibling) derivation's parent span
    lies inside ``[0, m)``.  ``target_ok (B, L)``: the target is a valid
    *non-root* cell -- the true root (level ``m-1``, pos 0) keeps its
    init value.  (cliora_tpu/ops/chart_pass.py:298-316)
    """
    L = n - level
    N = L - 1
    dev = lengths.device
    m = lengths[:, None]                                   # (B, 1)
    p = torch.arange(L, dtype=torch.int64, device=dev)[None, :]   # (1, L)
    c = torch.arange(N, dtype=torch.int64, device=dev)[:, None]   # (N, 1)
    j = p + level + 1                                      # exclusive end
    par_end = torch.where(c < p, j.expand(N, L), j + c - p + 1)
    combo_ok = par_end[None] <= m[..., None]               # (B, N, L)
    target_ok = (j <= m) & (level < m - 1)                 # (B, L)
    return combo_ok, target_ok


def outside_pass(cfg: ModelConfig, dp, inside_h: torch.Tensor,
                 inside_s: torch.Tensor,
                 inside_c: Optional[torch.Tensor] = None,
                 lengths: Optional[torch.Tensor] = None, mp=None):
    """Top-down pass mirroring :func:`inside_pass`.

    Parent states come from the *outside* chart, sibling states from the
    *inside* chart; compose input order is [sibling; parent] and the
    derivation softmax runs over the N parent/sibling combinations
    (reference: cliora/net/diora.py:152-200,337-376).

    ``lengths`` (B,) int enables padded length buckets (mlp arch only,
    as in the JAX package): a sentence of true length ``m <= n`` has its
    root vector planted at the true root cell ``(m-1, 0)``, derivations
    whose parent leaves ``[0, m)`` are masked out of the combo softmax,
    and invalid and root cells keep their prior values.  Returns
    ``(outside_h, outside_s, outside_c)``; ``outside_c`` is the TreeLSTM
    c chart (zero at the root), ``None`` for mlp.  ``mp``: as in
    :func:`inside_pass`.
    """
    B, NC, D = inside_h.shape
    n = int(round(((8 * NC + 1) ** 0.5 - 1) / 2))      # invert ncells
    assert ncells(n) == NC
    offs = level_offsets(n)
    cdt = compute_dtype(cfg)
    dev = inside_h.device
    use_c = cfg.arch == "treelstm"
    if lengths is not None and use_c:
        raise ValueError("padded buckets support the mlp arch only")

    cp = dp.get("outside_compose", dp["inside_compose"])
    mat = dp.get("outside_score", dp["inside_score"])["mat"]
    do_remat = remat_enabled(cfg, B, n, D)

    # root initialization (reference: cliora/net/diora.py:337-356), at
    # the true per-example root cell when padded
    if lengths is None:
        root_in = inside_h[:, -1]                       # (B, D)
    else:
        lengths = lengths.to(device=dev, dtype=torch.int64)
        root_cell = INDEX.offsets(n, dev)[lengths - 1]      # (B,)
        root_in = inside_h[torch.arange(B, device=dev), root_cell]
    if cfg.compress:
        # a bf16 chart row times the f32 matrix: f32, as JAX promotes
        root_h = root_in.float() @ dp["root_mat_out"]
    else:
        root_h = dp["root_vector_out_h"].reshape(1, D).expand(B, D)
    root_h = normalize(cfg.normalize, root_h).to(cdt)

    # levels[level] = (h (B, L, D), s (B, L), c (B, L, D) | None) of the
    # outside chart; the chart a level reads is the concatenation of the
    # levels above it
    zero_s = torch.zeros((B, 1), dtype=torch.float32, device=dev)
    zero_c = (torch.zeros((B, 1, D), dtype=cdt, device=dev) if use_c
              else None)
    levels = [None] * n
    # each level's h as the parents' gathers read it, and the inside chart
    # as the siblings' gathers read it
    copies = _copies_levels(cfg, mp)
    read_h = [None] * n
    inside_read = copy_to_mp(inside_h, mp) if copies else inside_h
    root_level = None
    if lengths is None:
        levels[n - 1] = (root_h[:, None], zero_s, zero_c)
    else:
        # the top cell of a padded sentence is a pad cell: it holds the
        # root vector only where m == n; everyone's true root is planted
        # into its own level below, as that level's prior value
        is_top = (lengths == n)[:, None]
        levels[n - 1] = (torch.where(is_top[..., None], root_h[:, None],
                                     torch.zeros((), dtype=cdt, device=dev)),
                         zero_s, None)
        root_level = lengths - 1                        # (B,)

    for level in range(n - 2, -1, -1):
        L = n - level
        N = L - 1
        par_idx, sis_idx = INDEX.outside(n, level, dev)
        # outside chart from this level's parents up: cells >= offs[level+1]
        base = int(offs[level + 1])

        def level_step(above_h, above_s, above_c, inside_h, inside_s,
                       inside_c, root_h, par_idx=par_idx, sis_idx=sis_idx,
                       base=base, level=level, L=L, N=N):
            par = par_idx - base
            ph = _take_children(torch.cat(above_h, 1), par)   # (B, N*L, D)
            sh = _take_children(inside_read, sis_idx)
            pc = sc = None
            if use_c:
                pc, sc = torch.cat(above_c, 1)[:, par], inside_c[:, sis_idx]
            h, c = _compose(cfg, cp, sh, ph, sc, pc, mp)

            s_bil = _score(cfg, mat, sh, ph, mp)            # (B, N*L)
            s = (s_bil + inside_s[:, sis_idx, 0]
                 + torch.cat(above_s, 1)[:, par]).reshape(B, N, L)
            if lengths is not None:
                combo_ok, target_ok = _outside_masks(level, n, lengths)
                s = torch.where(combo_ok, s,
                                torch.full((), MASK_NEG, device=dev))
            p = _aggregate_weights(cfg, s, 1)               # over combos

            h_agg = _weighted_agg("bnld,bnl->bld", h.reshape(B, N, L, D), p)
            s_agg = torch.sum(s * p, dim=1)                 # (B, L)
            h_agg = normalize(cfg.normalize, h_agg).to(cdt)
            c_agg = None
            if use_c:
                c_agg = normalize(cfg.normalize, _weighted_agg(
                    "bnld,bnl->bld", c.reshape(B, N, L, D), p)).to(cdt)

            if lengths is not None:
                # invalid targets and the true root keep their prior
                # values: zero, or the root vector at the root cell (its
                # gradient must reach the root vector / compress matrix)
                prior_h = torch.where(
                    (root_level == level)[:, None, None]
                    & (torch.arange(L, device=dev) == 0)[None, :, None],
                    root_h[:, None], torch.zeros((), dtype=cdt, device=dev))
                h_agg = torch.where(target_ok[..., None], h_agg, prior_h)
                s_agg = torch.where(target_ok, s_agg,
                                    torch.zeros((), device=dev))
            return h_agg, s_agg, c_agg

        above = levels[level + 1:]
        read_h[level + 1] = (copy_to_mp(above[0][0], mp) if copies
                             else above[0][0])
        levels[level] = _run_level(
            cfg, _remat_level(cfg, do_remat, N * L, n * (n - 1)),
            level_step, tuple(read_h[level + 1:]),
            tuple(lv[1] for lv in above),
            tuple(lv[2] for lv in above) if use_c else None,
            inside_h, inside_s, inside_c, root_h)

    outside_h = torch.cat([lv[0] for lv in levels], 1)
    outside_s = torch.cat([lv[1] for lv in levels], 1)[..., None]
    outside_c = torch.cat([lv[2] for lv in levels], 1) if use_c else None
    return outside_h, outside_s, outside_c


def run_chart(cfg: ModelConfig, dp, h0: torch.Tensor,
              c0: Optional[torch.Tensor] = None, obj=None,
              generator: Optional[torch.Generator] = None,
              train: bool = False, with_cky: bool = False,
              outside: bool = True,
              lengths: Optional[torch.Tensor] = None, mp=None) -> InsideOut:
    """Inside pass (+ CKY) and, with ``outside``, the outside pass.

    Padded length buckets need no inside mask: inside values of valid
    cells depend only on valid cells.  ``mp``: as in :func:`inside_pass`.
    """
    inside_h, inside_s, inside_c, bp, val = inside_pass(
        cfg, dp, h0, c0=c0, obj=obj, generator=generator, train=train,
        with_cky=with_cky, mp=mp)
    outside_h = outside_s = outside_c = None
    if outside:
        outside_h, outside_s, outside_c = outside_pass(
            cfg, dp, inside_h, inside_s, inside_c=inside_c, lengths=lengths,
            mp=mp)
    return InsideOut(inside_h, inside_s, inside_c, outside_h, outside_s,
                     outside_c, bp, val)
