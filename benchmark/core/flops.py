"""Operations and bytes from shapes, in closed form, and the card's peaks.

Only matmul-like work is counted (products and contractions, as
``torch.utils.flop_counter`` counts them; elementwise work is not).
Each term gives the count of the plain reference's formulation
(``plain``) and the least the program's repository knows (``least``):

* the child-linear terms of the chart passes (``fc0`` on ``[l; r]`` and
  the split score's ``a M``) taken once per chart cell rather than once
  per (cell, split) row, forward and backward, as kernel K1 takes them;
* the span x region best-score gradient taken through the argmax alone
  (``2 A M C D`` for each of the span and region gradients, as kernels K3
  and K4 take it) rather than through the dense score tensor.

A utilisation reads ``least``, so that no faster formulation reads over
the peak.

The kernel bounds are the program's own roofline arithmetic for K1
(``bound``) and K2-K4 (``sr_bound``), copied here so that a later change
to the program cannot change the yardstick.
"""

from __future__ import annotations

from typing import Dict

# Published H100 SXM peaks (NVIDIA's data sheet, dense): f32 outside the
# tensor cores, TF32, bf16 on the tensor cores, HBM3 bandwidth.
PEAK_FLOPS = {"float32": 67e12, "tf32": 495e12, "bfloat16": 989e12}
PEAK_BYTES = 3.35e12


def ncells(n: int) -> int:
    return n * (n + 1) // 2


def _term(plain, least=None, bwd=2.0, least_bwd=None):
    """A term's forward count ``plain`` with ``bwd`` times it again in the
    backward; ``least`` (forward) and ``least_bwd`` (backward) where a
    lesser formulation is known."""
    lf = plain if least is None else least
    lb = bwd * lf if least_bwd is None else least_bwd
    return {"forward": plain, "plain": plain * (1 + bwd),
            "least": min(lf + lb, plain * (1 + bwd))}


def train_step(cfg: Dict, B: int, n: int) -> Dict[str, Dict[str, float]]:
    """FLOP of one train step (forward and backward) on a (B, n) padded
    batch, by term."""
    D, E, k = cfg["size"], cfg["input_size"], cfg["k_neg"]
    NC = ncells(n)
    rows_in = (n ** 3 - n) // 6
    rows_out = (n ** 3 - n) // 3
    # a cell of one split (inside level 1) or one derivation (outside
    # level n - 2) aggregates by a multiply, not a sum of products
    agg_in, agg_out = rows_in - (n - 1), max(rows_out - 2, 0)
    emb = 1.0 + bool(cfg["emb_trainable"])        # grads of mat and table
    obj = cfg["use_obj"]
    vg = obj and cfg["vg_loss"]
    out = {
        "embed.span": _term(2 * B * n * E * D, bwd=emb),
        "embed.word": _term(2 * B * n * E * D, bwd=emb if vg else 0.0),
        "leaf": _term(2 * B * n * D * D),
        "inside.compose_fc1": _term(2 * B * rows_in * D * D),
        "inside.score_dot": _term(2 * B * rows_in * D),
        "inside.aggregate": _term(2 * B * agg_in * D),
        "inside.child_linear": _term(
            B * rows_in * (4 * D * D + 2 * D * D),
            least=B * (NC - 1) * 6 * D * D),
        "outside.compose_fc1": _term(2 * B * rows_out * D * D),
        "outside.score_dot": _term(2 * B * rows_out * D),
        "outside.aggregate": _term(2 * B * agg_out * D),
        "outside.child_linear": _term(
            B * rows_out * (4 * D * D + 2 * D * D),
            least=B * ((NC - 1) * 4 * D * D + (NC - n) * 2 * D * D)),
        "reconstruction.proj": _term(2 * (B * n + k) * E * D, bwd=emb),
        "reconstruction.scores": _term(2 * B * n * D * (1 + k)),
    }
    if obj:
        R, F = cfg["n_regions"], cfg["obj_feat_size"]
        out["image_encoder"] = _term(2 * B * R * F * D * (2 if vg else 1),
                                     bwd=1.0)
        if not vg:   # fc_vis runs in the forward, nothing reads it
            for k in ("forward", "plain", "least"):
                out["image_encoder"][k] += 2 * B * R * F * D
        out["leaf.attention"] = _term(4 * B * n * R * D)
        out["inside.attention"] = _term(4 * B * (NC - n) * R * D)
        if vg:
            out["vg.scores"] = _term(2 * B * B * n * R * D,
                                     least_bwd=2 * 2 * B * n * B * D)
        if cfg["use_contr"]:
            out["contrastive.scores"] = _term(
                2 * B * B * NC * R * D, least_bwd=2 * 2 * B * NC * B * D)
    return out


def parse_forward(cfg: Dict, B: int, n: int) -> Dict[str, Dict[str, float]]:
    """FLOP of the text parse's forward (embed, leaves, inside pass) on a
    (B, n) batch, by term."""
    D, E = cfg["size"], cfg["input_size"]
    rows = (n ** 3 - n) // 6
    NC = ncells(n)

    def fwd(plain, least=None):
        return {"forward": plain, "plain": plain,
                "least": plain if least is None else min(plain, least)}

    return {
        "embed.span": fwd(2 * B * n * E * D),
        "leaf": fwd(2 * B * n * D * D),
        "inside.compose_fc1": fwd(2 * B * rows * D * D),
        "inside.score_dot": fwd(2 * B * rows * D),
        "inside.aggregate": fwd(2 * B * (rows - (n - 1)) * D),
        "inside.child_linear": fwd(B * rows * 6 * D * D,
                                   B * (NC - 1) * 6 * D * D),
    }


def total(terms: Dict[str, Dict[str, float]], which: str = "least") -> float:
    return float(sum(t[which] for t in terms.values()))


# -- kernel bounds (the program's roofline arithmetic) ---------------------

def roofline(flops, nbytes, peak_flops):
    t_ops, t_bytes = flops / peak_flops, nbytes / PEAK_BYTES
    return {"flop": flops, "bytes": nbytes,
            "bound_s": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def k1_bound(b: int, n: int, d: int, dtype: str):
    """K1 (fused inside pass + CKY) on (b, n) sentences of width d: 6 D^2
    FLOP a chart cell below the root (its three projections) + 2 D^2 +
    2 D a (cell, split) row (the second layer and the split score's dot);
    f32 leaves and weights read once, the three (b, ncells) outputs
    written once."""
    rows = b * sum((n - lvl) * lvl for lvl in range(1, n))
    cells = b * (ncells(n) - 1)
    flops = cells * 6 * d * d + rows * (2 * d * d + 2 * d)
    nbytes = 4 * (b * n * d + 4 * d * d + 2 * d + 3 * b * ncells(n))
    return roofline(flops, nbytes, PEAK_FLOPS[dtype])


def sr_bound(kernel: str, A: int, M: int, C: int, R: int, D: int,
             span_bytes: int):
    """K2 (``span_region_fwd``), K3 (``span_region_dspan``) or K4
    (``span_region_dobj``) on spans (A, M, D) of ``span_bytes`` a value
    against regions (C, R, D).  K2: 2 A M C R D FLOP in the span dtype;
    reads span and the span-dtype regions, writes max and argmax.  K3 and
    K4: 2 A M C D FLOP of f32 FMA; K3 reads g, argmax and the f32 regions
    and writes the span gradient, K4 reads span, g and argmax and writes
    the f32 region gradient."""
    gam = 8 * A * C * M
    if kernel == "span_region_fwd":
        dtype = "bfloat16" if span_bytes == 2 else "float32"
        return roofline(2 * A * M * C * R * D,
                        span_bytes * (A * M * D + C * R * D) + gam,
                        PEAK_FLOPS[dtype])
    flops = 2 * A * M * C * D
    if kernel == "span_region_dspan":
        return roofline(flops, gam + 4 * C * R * D + span_bytes * A * M * D,
                        PEAK_FLOPS["float32"])
    if kernel == "span_region_dobj":
        return roofline(flops, span_bytes * A * M * D + gam + 4 * C * R * D,
                        PEAK_FLOPS["float32"])
    raise ValueError(kernel)


def train_step_sr_bound_s(cfg: Dict, B: int, n: int) -> float:
    """The bound seconds of one train step's K2-K4 calls: the VG call on
    f32 word vectors, the contrastive call on span vectors in the chart
    dtype, each a forward and both gradients."""
    if not cfg["use_obj"]:
        return 0.0
    D, R = cfg["size"], cfg["n_regions"]
    chart_bytes = 2 if cfg["compute_dtype"] == "bfloat16" else 4
    calls = []
    if cfg["vg_loss"]:
        calls.append((n, 4))
    if cfg["use_contr"]:
        calls.append((ncells(n), chart_bytes))
    return sum(sr_bound(k, B, M, B, R, D, es)["bound_s"]
               for M, es in calls
               for k in ("span_region_fwd", "span_region_dspan",
                         "span_region_dobj"))
