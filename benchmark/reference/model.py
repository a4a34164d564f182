"""DIORA / CLIORA forward, losses and optimizer step in plain PyTorch.

The mlp compose with shared inside/outside weights, unit normalization,
soft split aggregation and CLIORA's region attention (a residual at the
leaves and at every inside level), the outside pass from a learned root
vector, and the three losses: reconstruction (softmax over the true word
and ``k`` shared negatives), VG (InfoNCE over the batch's word x region
scores) and contrastive (a span-marginal-weighted hinge on the best
region of each span).  Padded length buckets are masked as the program
documents them (the outside derivations and the losses see only a
sentence's own cells).  Then the global-norm clip (optax's rule: scale
by ``max_norm / norm`` when ``norm >= max_norm``) and Adam
(0.9, 0.999, 1e-8) over the trainable leaves.

Parameters are a nested dict of f32 tensors with torch-layout linear
weights ``(out, in)``; every matrix product goes through a
:class:`~benchmark.reference.precision.Precision`.  With ``remat`` each
chart level runs under ``torch.utils.checkpoint``, so that a full-width
step fits beside nothing else on one card.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import torch
from torch.utils.checkpoint import checkpoint

from benchmark.reference import chart
from benchmark.reference.precision import Precision

MIN_HINGE = 1e-8          # the contrastive hinge clamps here, not at 0
MASK_NEG = -1e9           # masked outside derivations
NORM_EPS = 1e-8


def unit(x: torch.Tensor) -> torch.Tensor:
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True),
                           min=NORM_EPS)


def attend(P: Precision, h, obj, keep, dropout: float, temp: float):
    """Single-head attention of each span vector over its own image's
    regions (keys = values = regions); ``keep`` is the dropout mask."""
    prob = torch.softmax(P.einsum("bld,brd->blr", h, obj) / temp, dim=-1)
    if keep is not None:
        prob = torch.where(keep, prob / (1.0 - dropout),
                           torch.zeros((), device=prob.device))
    return P.einsum("blr,brd->bld", prob, obj)


def _run(remat: bool, fn, *args):
    if remat and torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False,
                          preserve_rng_state=False)
    return fn(*args)


def compose(P: Precision, cp, left, right):
    x = torch.cat([left, right], dim=-1)
    return torch.relu(P.linear(cp["fc1"], torch.relu(P.linear(cp["fc0"], x))))


def split_score(P: Precision, mat, a, b):
    """``(a M) . b`` per row."""
    return P.einsum("bmd,bmd->bm", P.einsum("bme,ed->bmd", a, mat), b)


def leaves(cfg: Dict, P: Precision, dp, x_span, obj_span=None, keep=None):
    h = torch.tanh(P.linear(dp["inside_compose"]["leaf_fc"], x_span))
    if obj_span is not None:
        h = unit(h)
        h = h + attend(P, h, obj_span, keep, cfg["attn_dropout"],
                       cfg["attn_temp"])
    return P.q(unit(h))


def inside(cfg: Dict, P: Precision, dp, h0, obj=None, keeps=None,
           remat=False, with_scores=False):
    """Bottom-up pass.  Returns the h chart (B, ncells, D), the score chart
    (B, ncells), and with ``with_scores`` each level's split scores
    (B, L, N) (detached)."""
    B, n, D = h0.shape
    cp, mat = dp["inside_compose"], dp["inside_score"]["mat"]
    hs = [h0]
    ss = [torch.zeros((B, n), device=h0.device)]
    levels = []
    for level in range(1, n):
        L, N = n - level, level
        il, ir = chart.index("inside", n, level, h0.device)
        keep = None if keeps is None else keeps[level]

        def step(keep, *prefix, il=il, ir=ir, L=L, N=N):
            k = len(prefix) // 2
            h_c, s_c = torch.cat(prefix[:k], 1), torch.cat(prefix[k:], 1)
            lh, rh = h_c[:, il], h_c[:, ir]
            hk = compose(P, cp, lh, rh)
            s = (split_score(P, mat, lh, rh) + s_c[:, il] + s_c[:, ir]
                 ).reshape(B, L, N)
            p = torch.softmax(s, dim=-1)
            h = unit(P.einsum("blnd,bln->bld", hk.reshape(B, L, N, D), p))
            if obj is not None:
                h = unit(h + attend(P, h, obj, keep, cfg["attn_dropout"],
                                    cfg["attn_temp"]))
            return P.q(h), torch.sum(s * p, dim=-1), s

        h, s_agg, s = _run(remat, step, keep, *hs, *ss)
        hs.append(h)
        ss.append(s_agg)
        if with_scores:
            levels.append(s.detach())
    return torch.cat(hs, 1), torch.cat(ss, 1), levels


def _outside_masks(level: int, n: int, lengths):
    L = n - level
    N = L - 1
    dev = lengths.device
    m = lengths[:, None]
    p = torch.arange(L, device=dev)[None, :]
    c = torch.arange(N, device=dev)[:, None]
    j = p + level + 1
    par_end = torch.where(c < p, j.expand(N, L), j + c - p + 1)
    combo_ok = par_end[None] <= m[..., None]
    target_ok = (j <= m) & (level < m - 1)
    return combo_ok, target_ok


def outside(cfg: Dict, P: Precision, dp, in_h, in_s, lengths=None,
            remat=False):
    """Top-down pass: parents from the outside chart, siblings from the
    inside chart, compose input ``[sibling; parent]``, a softmax over the
    derivations of each cell."""
    B, NC, D = in_h.shape
    n = int(round(((8 * NC + 1) ** 0.5 - 1) / 2))
    offs = chart.level_offsets(n)
    cp, mat = dp["inside_compose"], dp["inside_score"]["mat"]
    dev = in_h.device
    root_h = P.q(unit(dp["root_vector_out_h"]).reshape(1, D).expand(B, D))
    zero_s = torch.zeros((B, 1), device=dev)
    zero_h = torch.zeros((), device=dev)
    if lengths is None:
        top = root_h[:, None]
        root_level = None
    else:
        top = torch.where((lengths == n)[:, None, None], root_h[:, None],
                          zero_h)
        root_level = lengths - 1
    hs = {n - 1: top}
    ss = {n - 1: zero_s}
    for level in range(n - 2, -1, -1):
        L = n - level
        N = L - 1
        par, sis = chart.index("outside", n, level, dev)
        base = int(offs[level + 1])

        def step(in_h, in_s, *above, par=par - base, sis=sis, level=level,
                 L=L, N=N):
            k = len(above) // 2
            ph = torch.cat(above[:k], 1)[:, par]
            sh = in_h[:, sis]
            hk = compose(P, cp, sh, ph)
            s = (split_score(P, mat, sh, ph) + in_s[:, sis]
                 + torch.cat(above[k:], 1)[:, par]).reshape(B, N, L)
            if lengths is not None:
                combo_ok, target_ok = _outside_masks(level, n, lengths)
                s = torch.where(combo_ok, s, torch.full((), MASK_NEG,
                                                        device=dev))
            p = torch.softmax(s, dim=1)
            h = unit(P.einsum("bnld,bnl->bld", hk.reshape(B, N, L, D), p))
            s_agg = torch.sum(s * p, dim=1)
            if lengths is not None:
                first = torch.arange(L, device=dev) == 0
                prior = torch.where(
                    (root_level == level)[:, None, None]
                    & first[None, :, None], root_h[:, None], zero_h)
                h = torch.where(target_ok[..., None], h, prior)
                s_agg = torch.where(target_ok, s_agg, zero_h)
            return P.q(h), s_agg

        above = list(range(level + 1, n))
        hs[level], ss[level] = _run(
            remat, step, in_h, in_s, *[hs[a] for a in above],
            *[ss[a] for a in above])
    return (torch.cat([hs[lv] for lv in range(n)], 1),
            torch.cat([ss[lv] for lv in range(n)], 1))


def best_region(P: Precision, span, obj):
    """(A, M, D) x (C, R, D) -> (A, C, M): each span's best region score
    in each image; its gradient goes to the first best region."""
    return torch.max(P.einsum("amd,crd->acmr", span, obj), dim=-1).values


def reconstruction_loss(P: Precision, rmat, table, tokens, neg, out_h,
                        lengths=None):
    B, L = tokens.shape
    cell = out_h[:, :L]
    pos = P.einsum("ble,de->bld", table[tokens], rmat)
    negs = P.einsum("ke,de->kd", table[neg], rmat)
    xp = P.einsum("bld,bld->bl", pos, cell)[..., None]
    xn = P.einsum("kd,bld->blk", negs, cell)
    score = torch.cat([xp, xn], dim=-1)
    per_word = torch.logsumexp(score, dim=-1) - score[..., 0]
    if lengths is None:
        return per_word.mean()
    mask = torch.arange(L, device=tokens.device)[None] < lengths[:, None]
    return torch.sum(per_word * mask) / torch.sum(mask)


def vg_loss(best, lengths=None):
    """``best``: (B_text, B_image, L) best-region score of each word."""
    L = best.shape[2]
    if lengths is None:
        logits = best.sum(-1) / L
    else:
        mask = (torch.arange(L, device=best.device)[None]
                < lengths[:, None])[:, None, :]
        logits = (best * mask).sum(-1) / lengths[:, None].float()
    return torch.mean(torch.logsumexp(logits, dim=1) - torch.diagonal(logits))


def contrastive_loss(in_s, out_s, best, margin: float, lengths=None):
    """``best``: (B_text, B_image, ncells) best-region score of each span.
    Hinges against the matched pair in both directions, weighted by the
    span marginals ``exp(inside + outside - root)``, over the first half
    of each sentence's own chart (its shortest spans)."""
    B, NC = in_s.shape
    n = int(round(((8 * NC + 1) ** 0.5 - 1) / 2))
    dev = in_s.device
    sc = best.permute(2, 0, 1)                              # (NC, Bt, Bi)
    diag = torch.diagonal(sc, dim1=-2, dim2=-1)             # (NC, B)
    eye = torch.eye(B, dtype=torch.bool, device=dev)[None]
    zero = torch.zeros((), device=dev)
    drop = eye
    if lengths is not None:
        lev, pos = (torch.as_tensor(a, device=dev)[None]
                    for a in chart.cell_coords(n))
        m = lengths[:, None]
        valid = pos + lev + 1 <= m                          # (B, NC)
        rank = lev * m - lev * (lev - 1) // 2 + pos
        half_mask = valid & (rank < (m * (m + 1) // 2) // 2)
        drop = eye | (~valid).T[:, :, None]
    l_txt = torch.where(drop, zero, torch.clamp(margin + sc - diag[:, :, None],
                                                min=MIN_HINGE)).mean(dim=2)
    l_img = torch.where(drop, zero, torch.clamp(margin + sc - diag[:, None, :],
                                                min=MIN_HINGE)).mean(dim=1)
    vl = (l_txt + l_img).T                                   # (B, NC)
    if lengths is None:
        margs = torch.exp(in_s + out_s - in_s[:, -1:])
        return torch.mean(torch.sum((margs * vl)[:, :NC // 2], dim=-1))
    offs = torch.as_tensor(chart.level_offsets(n), device=dev)
    root_s = torch.gather(in_s, 1, offs[lengths - 1][:, None])
    margs = torch.exp(torch.where(half_mask, in_s + out_s - root_s, zero)) \
        * half_mask
    return torch.mean(torch.sum(margs * vl, dim=-1))


def dropout_keeps(cfg: Dict, B: int, n: int, seed: int, device):
    """The step's attention dropout masks, drawn as the program draws
    them: a ``torch.Generator`` on the device seeded ``seed``, one
    ``torch.rand`` for the leaves (B, n, R), then one for each inside
    level (B, n - level, R), each kept where below ``1 - dropout``."""
    if not cfg["use_obj"] or cfg["attn_dropout"] <= 0.0:
        return None
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    R, keep = cfg["n_regions"], 1.0 - cfg["attn_dropout"]
    out = [torch.rand((B, n, R), generator=g, device=device) < keep]
    for level in range(1, n):
        out.append(torch.rand((B, n - level, R), generator=g,
                              device=device) < keep)
    return out


def losses(cfg: Dict, P: Precision, params, batch, keeps=None, remat=False
           ) -> Dict[str, torch.Tensor]:
    """All losses of one train step; ``batch`` holds device tensors
    ``sentences``, ``neg_samples`` and, as the configuration has them,
    ``obj_feats`` and ``lengths``."""
    tokens, neg = batch["sentences"], batch["neg_samples"]
    lengths = batch.get("lengths")
    ep, dp = params["embed"], params["diora"]
    table = ep["embeddings"]
    if not cfg["emb_trainable"]:
        table = table.detach()
    emb = table[tokens]
    x_span = P.einsum("ble,de->bld", emb, ep["mat"])
    x_word = P.einsum("ble,de->bld", emb, ep["mat1"])
    obj_span = obj_word = None
    if cfg["use_obj"]:
        feats = batch["obj_feats"].float()
        obj_span = P.linear(params["img_encoder"]["fc"], feats)
        obj_word = P.linear(params["img_encoder"]["fc_vis"], feats)
    h0 = leaves(cfg, P, dp, x_span, obj_span,
                None if keeps is None else keeps[0])
    in_h, in_s, _ = inside(cfg, P, dp, h0, obj_span, keeps, remat)
    out_h, out_s = outside(cfg, P, dp, in_h, in_s, lengths, remat)
    out = {"reconstruction_softmax_loss": reconstruction_loss(
        P, params["reconstruct"]["mat"], table, tokens, neg, out_h, lengths)}
    if cfg["use_obj"] and cfg["vg_loss"]:
        out["vg_loss"] = cfg["alpha_vg"] * vg_loss(
            best_region(P, x_word, obj_word), lengths)
    if cfg["use_obj"] and cfg["use_contr"]:
        best = best_region(P, in_h + out_h, obj_span)
        out["contrastive_loss"] = cfg["alpha_contr"] * contrastive_loss(
            in_s, out_s, best, cfg["vl_margin"], lengths)
    out["total_loss"] = sum(out.values())
    return out


def leaf_paths(tree, prefix: str = "") -> List[str]:
    if isinstance(tree, dict):
        return [p for k, v in tree.items()
                for p in leaf_paths(v, f"{prefix}{k}/")]
    return [prefix[:-1]]


def leaves_of(tree) -> List[torch.Tensor]:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in leaves_of(v)]
    return [tree]


def trainable(cfg: Dict, path: str) -> bool:
    return cfg["emb_trainable"] or not path.endswith("embeddings")


ADAM_BETAS = (0.9, 0.999)
ADAM_EPS = 1e-8


class Adam:
    """Adam over the trainable leaves with the global-norm clip before
    it."""

    def __init__(self, cfg: Dict, params):
        self.cfg = cfg
        self.names = [p for p in leaf_paths(params) if trainable(cfg, p)]
        by_path = dict(zip(leaf_paths(params), leaves_of(params)))
        self.params = [by_path[p] for p in self.names]
        self.m = [torch.zeros_like(p) for p in self.params]
        self.v = [torch.zeros_like(p) for p in self.params]
        self.t = 0

    @torch.no_grad()
    def step(self, grads: List[torch.Tensor]) -> List[torch.Tensor]:
        """Clips ``grads`` by their global norm, applies one update, and
        returns the clipped gradients."""
        cfg = self.cfg
        norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
        max_norm = cfg["grad_clip"]
        if float(norm) >= max_norm:
            grads = [g / norm * max_norm for g in grads]
        self.t += 1
        (b1, b2), eps, lr = ADAM_BETAS, ADAM_EPS, cfg["lr"]
        c1, c2 = 1 - b1 ** self.t, 1 - b2 ** self.t
        for p, g, m, v in zip(self.params, grads, self.m, self.v):
            m.mul_(b1).add_(g, alpha=1 - b1)
            v.mul_(b2).addcmul_(g, g, value=1 - b2)
            p.sub_(lr * (m / c1) / (torch.sqrt(v / c2) + eps))
        return grads


def clone_params(params, device, requires_grad=True):
    if isinstance(params, dict):
        return {k: clone_params(v, device, requires_grad)
                for k, v in params.items()}
    return params.detach().to(device=device, dtype=torch.float32,
                              copy=True).requires_grad_(requires_grad)


def train_steps(cfg: Dict, params0, batches, seeds, device,
                precision: str = "float32", remat: bool = False,
                grads_at=frozenset({0})):
    """``len(batches)`` optimizer steps from ``params0``.  Step ``k`` draws
    its dropout masks from ``seeds[k]``.  Returns ``{"losses": [ {name:
    float} per step ], "grads": {k: {path: clipped gradient of step k}}
    for each ``k`` in ``grads_at``, "params": {path: tensor after the
    last step}, "params0": {path: initial tensor}}``, host tensors for
    the trainable leaves."""
    P = Precision(precision)
    params = clone_params(params0, device)
    opt = Adam(cfg, params)
    start = {k: p.detach().cpu().clone()
             for k, p in zip(opt.names, opt.params)}
    out = {"losses": [], "grads": {}, "params0": start}
    for k, batch in enumerate(batches):
        b = {key: torch.as_tensor(v).to(device) for key, v in batch.items()}
        B, n = b["sentences"].shape
        keeps = dropout_keeps(cfg, B, n, seeds[k], device)
        for p in opt.params:
            p.grad = None
        ls = losses(cfg, P, params, b, keeps, remat)
        grads = torch.autograd.grad(ls["total_loss"], opt.params,
                                    allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(opt.params, grads)]
        clipped = opt.step(grads)
        out["losses"].append({key: float(v.detach())
                              for key, v in ls.items()})
        if k in grads_at:
            out["grads"][k] = {name: g.detach().cpu().clone()
                               for name, g in zip(opt.names, clipped)}
        del ls, grads, clipped
    out["params"] = {k: p.detach().cpu().clone()
                     for k, p in zip(opt.names, opt.params)}
    return out


def norm(t: torch.Tensor) -> float:
    return math.sqrt(float(torch.sum(t.double() * t.double())))


def worst_leaf_gap(got: Dict[str, torch.Tensor],
                   want: Dict[str, torch.Tensor],
                   skip: Optional[set] = None) -> Dict:
    """The gap between the program's norm of each leaf and the
    reference's, over the reference's norm of that leaf or of the median
    leaf, whichever is larger; the worst leaf and its reading."""
    names = [k for k in want if not skip or k not in skip]
    want_n = {k: norm(want[k]) for k in names}
    med = sorted(want_n.values())[len(want_n) // 2] if want_n else 0.0
    worst, leaf = 0.0, None
    for k in names:
        if k not in got:
            return {"value": float("inf"), "leaf": k}
        gap = abs(norm(got[k]) - want_n[k]) / max(want_n[k], med, 1e-30)
        if not math.isfinite(gap):
            return {"value": float("inf"), "leaf": k}
        if gap >= worst:
            worst, leaf = gap, k
    return {"value": worst, "leaf": leaf}
