"""Remat of the chart levels in the port: a rematerialized step against
the unremated one over the JAX test's four (frac, policy) cases
(tests/test_chart_pass.py:154-195) and on a TreeLSTM model; against JAX
remat; under attention dropout with a generator (the recompute applies
the forward's mask and the generator ends where the unremated step
leaves it); the ``remat_enabled`` decisions against the JAX function at
its factor; and the ``--remat*`` flags."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cliora_tpu.models.config import ModelConfig as JaxConfig
from cliora_tpu.ops import chart_pass as jchart
from cliora_tpu.scripts import common as jcommon
from cliora_tpu.training import checkpoint as jckpt
from cliora_tpu.training import trainer as jt
from cliora_tpu.utils import flags as jflags
from cliora_tpu_torch.models.config import ModelConfig
from cliora_tpu_torch.ops import chart_pass as tchart
from cliora_tpu_torch.scripts import common as tcommon
from cliora_tpu_torch.training import checkpoint as tckpt
from cliora_tpu_torch.training import trainer as tt
from cliora_tpu_torch.utils import flags as tflags
from torch_parity import jax_tree, port_init

V, R, F, K = 50, 3, 12, 5
# the JAX test's limits: recompute may reassociate f32 sums
REMAT_RTOL, REMAT_ATOL = 1e-4, 2e-6


def _configs(arch="mlp", attn_dropout=0.0, **remat):
    cfg = ModelConfig(size=12, input_size=10, use_obj=True, n_regions=R,
                      obj_feat_size=F, attn_dropout=attn_dropout, arch=arch)
    tc = tt.TrainConfig(lr=1e-3, k_neg=K, vg_loss=True, use_contr=True,
                        emb_trainable=True, attn_impl="chunked")
    return cfg, dataclasses.replace(cfg, remat=True, **remat), tc


def _batch(seed=0):
    rs = np.random.RandomState(seed)
    return (torch.as_tensor(rs.randint(2, V, (3, 7))),
            torch.as_tensor(rs.choice(V, K, replace=False)),
            torch.as_tensor(rs.randn(3, R, F).astype(np.float32)))


def _loss_and_grads(cfg, tc, flat, batch, generator=None):
    params = tckpt.params_from_numpy(flat, "cpu")
    for p in tt.tree_leaves(params):
        p.requires_grad_()
    toks, neg, obj = batch
    total, _ = tt.compute_losses(cfg, tc, params, toks, neg, obj_feats=obj,
                                 generator=generator, train=True)
    total.backward()
    return float(total.detach()), {
        k: p.grad.numpy() for k, p in zip(tt.tree_paths(params),
                                          tt.tree_leaves(params))
        if p.grad is not None}


def _assert_same(got, want):
    np.testing.assert_allclose(got[0], want[0], rtol=1e-6)
    assert set(got[1]) == set(want[1])
    for k in want[1]:
        np.testing.assert_allclose(got[1][k], want[1][k], rtol=REMAT_RTOL,
                                   atol=REMAT_ATOL, err_msg=k)


@pytest.mark.parametrize("arch,frac,policy", [
    ("mlp", 0.0, "full"), ("mlp", 0.6, "full"), ("mlp", 0.0, "dots"),
    ("mlp", 0.0, "gathers"), ("treelstm", 0.0, "full")])
def test_remat_matches_unremated(arch, frac, policy):
    cfg, cfg_r, tc = _configs(arch, remat_frac=frac, remat_policy=policy)
    flat = port_init(cfg, tc, V, seed=0)
    batch = _batch()
    _assert_same(_loss_and_grads(cfg_r, tc, flat, batch),
                 _loss_and_grads(cfg, tc, flat, batch))


def test_remat_checkpoints_the_levels():
    """Under 'full' remat a level's intermediates are not stored: the
    tensors autograd keeps outside the checkpointed levels hold fewer
    bytes than the unremated step's."""
    cfg, cfg_r, tc = _configs()
    flat = port_init(cfg, tc, V, seed=0)

    def saved_bytes(c):
        total = [0]

        def pack(t):
            total[0] += t.numel() * t.element_size()
            return t

        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            _loss_and_grads(c, tc, flat, _batch())
        return total[0]

    assert saved_bytes(cfg_r) < 0.6 * saved_bytes(cfg)


def test_remat_matches_jax_remat():
    """Port remat against JAX remat (selective, 'dots') on the same
    weights: losses and gradients at the port's train-step limits."""
    cfg, cfg_r, tc = _configs(remat_frac=0.5, remat_policy="dots")
    jcfg = JaxConfig(**{f.name: getattr(cfg_r, f.name)
                        for f in dataclasses.fields(JaxConfig)
                        if f.name != "parse_impl"})
    jtc = jt.TrainConfig(lr=1e-3, k_neg=K, vg_loss=True, use_contr=True,
                         emb_trainable=True, attn_impl="chunked")
    flat = port_init(cfg, tc, V, seed=1)
    batch = _batch(1)
    toks, neg, obj = (jnp.asarray(x.numpy()) for x in batch)

    def loss(p):
        return jt.compute_losses(jcfg, jtc, p, toks, neg, obj_feats=obj,
                                 rng=None, train=True)[0]

    want_l, want_g = jax.jit(jax.value_and_grad(loss))(jax_tree(flat))
    want_g = jckpt.flatten(want_g)
    got_l, got_g = _loss_and_grads(cfg_r, tc, flat, batch)
    np.testing.assert_allclose(got_l, float(want_l), rtol=1e-4)
    for k in want_g:
        scale = max(1.0, float(np.abs(want_g[k]).max()))
        np.testing.assert_allclose(got_g.get(k, 0 * want_g[k]) / scale,
                                   want_g[k] / scale, atol=1e-5, err_msg=k)


@pytest.mark.parametrize("policy", ["full", "dots", "gathers"])
def test_remat_with_dropout_matches_unremated(policy):
    """At attn_dropout 0.1 with a generator: the recomputed levels apply
    the masks the forward drew, so the gradients equal the unremated
    step's, and the generator ends in the unremated step's state."""
    cfg, cfg_r, tc = _configs(attn_dropout=0.1, remat_policy=policy)
    flat = port_init(cfg, tc, V, seed=2)
    batch = _batch(2)
    gens = [torch.Generator().manual_seed(11) for _ in range(2)]
    want = _loss_and_grads(cfg, tc, flat, batch, gens[0])
    got = _loss_and_grads(cfg_r, tc, flat, batch, gens[1])
    _assert_same(got, want)
    assert torch.equal(gens[0].get_state(), gens[1].get_state())
    # the masks did drop: another seed gives another loss
    other = _loss_and_grads(cfg, tc, flat, batch,
                            torch.Generator().manual_seed(12))
    assert other[0] != want[0]


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("remat,budget", [
    ("auto", 10.0), ("auto", 1e-6), ("auto", 40.0), (True, 10.0),
    (False, 10.0)])
def test_remat_enabled_matches_jax(monkeypatch, dtype, remat, budget):
    """The port's decision equals the JAX one at the JAX factor over the
    shapes of the JAX test (tests/test_chart_pass.py:198-222)."""
    monkeypatch.setattr(tchart, "_ACT_COPY_FACTOR", jchart._ACT_COPY_FACTOR)
    kw = dict(size=400, remat=remat, remat_budget_gb=budget,
              compute_dtype=dtype)
    cfg, jcfg = ModelConfig(**kw), JaxConfig(**kw)
    for B, n, D in ((128, 40, 400), (64, 40, 400), (128, 20, 400),
                    (256, 20, 400), (128, 32, 400), (2, 6, 12),
                    (1024, 48, 1024)):
        assert (tchart.remat_enabled(cfg, B, n, D)
                == jchart.remat_enabled(jcfg, B, n, D)), (B, n, D)


@pytest.mark.parametrize("cells,peak,frac,want", [
    (24, 24, 0.85, True), (20, 24, 0.85, False), (1, 24, 0.0, True)])
def test_remat_level_matches_jax(cells, peak, frac, want):
    cfg = ModelConfig(remat=True, remat_frac=frac)
    jcfg = JaxConfig(remat=True, remat_frac=frac)
    assert tchart._remat_level(cfg, True, cells, peak) is want
    assert jchart._remat_level(jcfg, True, cells, peak) is want
    assert tchart._remat_level(cfg, False, cells, peak) is False


@pytest.mark.parametrize("args", [
    [], ["--remat"], ["--remat", "auto", "--remat_budget_gb", "0.000001"],
    ["--remat", "true", "--remat_frac", "0.85", "--remat_policy", "dots"],
    ["--remat", "false", "--remat_policy", "gathers"]])
def test_remat_flags_match_jax(args, tmp_path):
    """``--remat`` (bare: True), ``--remat auto`` and the budget, frac and
    policy flags parse as in the JAX flags and reach ``ModelConfig`` as
    the JAX ``model_config_from_options`` puts them."""
    args = args + ["--experiment_path", str(tmp_path)]
    got = tflags.parse_args(tflags.argument_parser(), args)
    want = jflags.parse_args(jflags.argument_parser(), args)
    names = ("remat", "remat_budget_gb", "remat_frac", "remat_policy")
    assert [getattr(got, k) for k in names] == \
        [getattr(want, k) for k in names]
    cfg = tcommon.model_config_from_options(got, 100)
    jcfg = jcommon.model_config_from_options(want, 100)
    assert [getattr(cfg, k) for k in names] == \
        [getattr(jcfg, k) for k in names]


def test_config_validates_remat():
    for bad in (dict(remat="sometimes"), dict(remat_policy="some")):
        with pytest.raises(ValueError):
            ModelConfig(**bad)
