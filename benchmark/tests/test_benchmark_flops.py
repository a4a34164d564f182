"""The closed-form FLOP counts against ``FlopCounterMode`` over the plain
reference, the copied kernel bounds against the numbers they gave, and
the idle share's union of intervals."""

from __future__ import annotations

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark.core import flops, traffic, weights
from benchmark.core.trace import Trace
from benchmark.reference import cky, model
from benchmark.reference.precision import Precision
from benchmark.tests.conftest import tiny_config, tiny_train_mix

CPU = torch.device("cpu")
P = Precision("float32")


def _batch(cfg, n, lengths, seed=1):
    spec = tiny_train_mix(lengths={"law": "fixed", "value": n})
    bank = (traffic.image_bank(spec, cfg, seed, CPU) if cfg["use_obj"]
            else None)
    b = traffic.TrainMix(spec, cfg, seed, bank).batch(n)
    if not lengths:
        b.pop("lengths")
    return {k: torch.as_tensor(v) for k, v in b.items()}


def _count(fn):
    with FlopCounterMode(display=False) as fc:
        fn()
    return fc.get_total_flops()


@pytest.mark.parametrize("config", ["cliora-flickr-bf16", "diora-flickr-f32"])
@pytest.mark.parametrize("lengths", [False, True])
@pytest.mark.parametrize("n", [2, 5, 7])
def test_train_step_count_is_the_reference_step(config, lengths, n):
    cfg = tiny_config(config, compute_dtype="float32")
    params = model.clone_params(weights.make(cfg, 2, CPU), CPU)
    opt = model.Adam(cfg, params)
    batch = _batch(cfg, n, lengths)
    keeps = model.dropout_keeps(cfg, batch["sentences"].shape[0], n, 9, CPU)

    def step():
        ls = model.losses(cfg, P, params, batch, keeps)
        torch.autograd.grad(ls["total_loss"], opt.params, allow_unused=True)

    terms = flops.train_step(cfg, batch["sentences"].shape[0], n)
    assert _count(step) == flops.total(terms, "plain")


@pytest.mark.parametrize("n", [2, 6])
def test_forward_terms_each_match(n):
    """The chart passes' terms and the losses' terms, forward, one by
    one."""
    cfg = tiny_config("cliora-flickr-bf16", compute_dtype="float32")
    params = model.clone_params(weights.make(cfg, 3, CPU), CPU, False)
    batch = _batch(cfg, n, lengths=False)
    B = batch["sentences"].shape[0]
    terms = flops.train_step(cfg, B, n)
    fwd = {k: v["forward"] for k, v in terms.items()}
    dp, ep = params["diora"], params["embed"]
    obj = P.linear(params["img_encoder"]["fc"], batch["obj_feats"])
    emb = ep["embeddings"][batch["sentences"]]
    h0 = model.leaves(cfg, P, dp, P.einsum("ble,de->bld", emb, ep["mat"]),
                      obj)
    assert _count(lambda: model.inside(cfg, P, dp, h0, obj)) == sum(
        v for k, v in fwd.items()
        if k.startswith("inside."))
    in_h, in_s, _ = model.inside(cfg, P, dp, h0, obj)
    assert _count(lambda: model.outside(cfg, P, dp, in_h, in_s)) == sum(
        v for k, v in fwd.items() if k.startswith("outside."))
    out_h, _ = model.outside(cfg, P, dp, in_h, in_s)
    assert _count(lambda: model.reconstruction_loss(
        P, params["reconstruct"]["mat"], ep["embeddings"],
        batch["sentences"], batch["neg_samples"], out_h)) == (
        fwd["reconstruction.proj"] + fwd["reconstruction.scores"])
    assert _count(lambda: model.best_region(P, in_h + out_h, obj)) == \
        fwd["contrastive.scores"]
    x_span = P.einsum("ble,de->bld", emb, ep["mat"])
    assert _count(lambda: model.leaves(cfg, P, dp, x_span, obj)) == (
        fwd["leaf"] + fwd["leaf.attention"])
    assert _count(lambda: P.einsum("ble,de->bld", emb, ep["mat"])) == \
        fwd["embed.span"]


@pytest.mark.parametrize("n", [2, 5, 9])
def test_parse_forward_count_is_the_reference_forward(n):
    cfg = tiny_config("diora-flickr-f32")
    params = model.clone_params(weights.make(cfg, 4, CPU), CPU, False)
    tokens = torch.randint(0, cfg["vocab_size"], (5, n))
    terms = flops.parse_forward(cfg, 5, n)
    assert _count(lambda: cky.split_costs(cfg, params, tokens)) == \
        flops.total(terms, "plain")


@pytest.mark.parametrize("config", ["cliora-flickr-bf16", "diora-flickr-f32"])
@pytest.mark.parametrize("n", [2, 3, 20, 40])
def test_least_never_exceeds_plain(config, n):
    cfg = tiny_config(config)
    for terms in (flops.train_step(cfg, 128, n),
                  flops.parse_forward(cfg, 128, n)):
        for name, t in terms.items():
            assert 0 <= t["least"] <= t["plain"], name
    # the hoisted child-linear terms are K1's: 6 D^2 a cell below the root
    D = cfg["size"]
    hoisted = 128 * (flops.ncells(n) - 1) * 6 * D * D
    assert flops.parse_forward(cfg, 128, n)["inside.child_linear"][
        "least"] == min(hoisted, 128 * (n ** 3 - n) // 6 * 6 * D * D)


def test_k1_bound_is_the_one_recorded():
    """K1 f32 at B=128, n=20, D=400: 1.198 ms, bound by operations."""
    b = flops.k1_bound(128, 20, 400, "float32")
    assert b["bound_by"] == "operations"
    assert round(b["bound_s"] * 1e3, 3) == 1.198
    assert round(flops.k1_bound(128, 20, 400, "bfloat16")["bound_s"] * 1e3,
                 3) == 0.081


def test_span_region_bounds_are_the_ones_recorded():
    """K2 bf16 at the contrastive call of the L=20 step, span (128, 210,
    400) against regions (128, 36, 400): 0.100 ms; K3 and K4 there
    0.041 ms; the f32 VG K2 0.141 ms."""
    A, M, C, R, D = 128, 210, 128, 36, 400
    k2 = flops.sr_bound("span_region_fwd", A, M, C, R, D, 2)
    assert round(k2["bound_s"] * 1e3, 3) == 0.100
    for k in ("span_region_dspan", "span_region_dobj"):
        assert round(flops.sr_bound(k, A, M, C, R, D, 2)["bound_s"] * 1e3,
                     3) == 0.041
    vg = flops.sr_bound("span_region_fwd", 128, 20, 128, 36, 400, 4)
    assert round(vg["bound_s"] * 1e3, 3) == 0.141


def test_idle_share_takes_the_union_of_two_streams():
    # stream A busy [0, 4) and [6, 7); stream B busy [2, 5), overlapping A
    ops = [("a1", 0.0, 4.0), ("b1", 2.0, 5.0), ("a2", 6.0, 7.0)]
    tr = Trace(ops, [("decode", 5.0, 6.0)], (0.0, 10.0))
    assert tr.busy_s == pytest.approx(6.0)
    assert 1 - tr.busy_s / tr.window_s == pytest.approx(0.4)
    gaps = dict(tr.gaps())
    assert gaps == {"decode": pytest.approx(1.0), "host": pytest.approx(3.0)}
    # an operation outside the window counts only within it
    tr2 = Trace([("x", -1.0, 1.0), ("y", 9.5, 12.0)], [], (0.0, 10.0))
    assert tr2.busy_s == pytest.approx(1.5)
