"""The TreeLSTM arch of the port against the JAX package on the same
weights: ``compose_treelstm`` (f32, and bf16 by the closeness and cosine
limits of tests/test_bf16.py), the leaf ``(h, c)`` and the inside and
outside charts with their c chart (the JAX ``test_treelstm_arch_runs``
shape), one CLIORA ``compute_losses`` with its gradients, ``.npz`` and
``.pt`` checkpoint trips both ways, the ``lengths`` refusal and the
export refusal.  f32, dropout off."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cliora_tpu.models import diora as jdiora
from cliora_tpu.models.config import ModelConfig as JaxConfig
from cliora_tpu.models.params import init_params as jax_init_params
from cliora_tpu.ops import chart_pass as jchart
from cliora_tpu.ops.core import compose_treelstm as jax_compose
from cliora_tpu.training import checkpoint as jckpt
from cliora_tpu.training import trainer as jt
from cliora_tpu_torch import serving
from cliora_tpu_torch.models import diora as tdiora
from cliora_tpu_torch.models.config import ModelConfig
from cliora_tpu_torch.ops import chart_pass as tchart
from cliora_tpu_torch.ops.core import compose_treelstm
from cliora_tpu_torch.training import checkpoint as tckpt
from cliora_tpu_torch.training import trainer as tt

D, E, V, R, F, K = 16, 24, 50, 4, 32, 5
B, L = 4, 5
COMPOSE_ATOL = 1e-6
CHART_ATOL = 1e-6
SCORE_ATOL = 2e-4          # tests/test_torch_chart_pass.py (f32 scores)
LOSS_RTOL = 1e-4           # tests/test_torch_train_step.py
GRAD_ATOL = 1e-5           # ditto, over each gradient's largest entry
BF16_ATOL, BF16_COS = 0.05, 0.99   # tests/test_bf16.py


def _compose_inputs(seed=0, rows=7):
    rs = np.random.RandomState(seed)
    lh, rh, lc, rc = (rs.randn(3, rows, D).astype(np.float32)
                      for _ in range(4))
    cp = {"W": (rs.randn(5 * D, 2 * D) / np.sqrt(2 * D)).astype(np.float32),
          "b": (0.1 * rs.randn(5 * D)).astype(np.float32)}
    return cp, lh, rh, lc, rc


def _torch_tree(cp):
    return {k: torch.from_numpy(v) for k, v in cp.items()}


def test_compose_treelstm_matches_jax():
    """h and c within 1e-6 at f32, f32 out; gradients of every input
    and weight through a random projection of (h, c)."""
    cp, lh, rh, lc, rc = _compose_inputs()
    wh, wc = (np.random.RandomState(1).randn(3, 7, D).astype(np.float32)
              for _ in range(2))

    def jloss(cp, lh, rh, lc, rc):
        h, c = jax_compose(cp, (lh, lc), (rh, rc))
        return jnp.sum(h * wh) + jnp.sum(c * wc), (h, c)

    (_, (jh, jc)), jg = jax.value_and_grad(
        jloss, argnums=(0, 1, 2, 3, 4), has_aux=True)(cp, lh, rh, lc, rc)
    tcp = {k: v.requires_grad_() for k, v in _torch_tree(cp).items()}
    ins = [torch.from_numpy(x).requires_grad_() for x in (lh, rh, lc, rc)]
    th, tc = compose_treelstm(tcp, (ins[0], ins[2]), (ins[1], ins[3]))
    assert th.dtype == tc.dtype == torch.float32
    np.testing.assert_allclose(th.detach().numpy(), np.asarray(jh),
                               atol=COMPOSE_ATOL)
    np.testing.assert_allclose(tc.detach().numpy(), np.asarray(jc),
                               atol=COMPOSE_ATOL)
    (torch.sum(th * torch.from_numpy(wh))
     + torch.sum(tc * torch.from_numpy(wc))).backward()
    for k in cp:
        np.testing.assert_allclose(tcp[k].grad.numpy(), np.asarray(jg[0][k]),
                                   atol=1e-5, err_msg=k)
    for got, want in zip(ins, jg[1:]):
        np.testing.assert_allclose(got.grad.numpy(), np.asarray(want),
                                   atol=1e-5)


def _cos(a, b):
    a, b = np.ravel(a).astype(np.float64), np.ravel(b).astype(np.float64)
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))


def test_compose_treelstm_bf16_tracks_jax():
    """bf16 gates in both packages: f32 h and c, within the bf16 limits
    of tests/test_bf16.py of the JAX bf16 and f32 composes."""
    cp, lh, rh, lc, rc = _compose_inputs(seed=2)
    tcp = _torch_tree(cp)
    th, tc = compose_treelstm(
        tcp, (torch.from_numpy(lh).bfloat16(), torch.from_numpy(lc)),
        (torch.from_numpy(rh).bfloat16(), torch.from_numpy(rc)),
        compute_dtype=torch.bfloat16)
    assert th.dtype == tc.dtype == torch.float32
    for jdt in (jnp.bfloat16, jnp.float32):
        jh, jc = jax_compose(cp, (jnp.asarray(lh, jnp.bfloat16), lc),
                             (jnp.asarray(rh, jnp.bfloat16), rc),
                             compute_dtype=jdt)
        for got, want in ((th, jh), (tc, jc)):
            want = np.asarray(want, np.float32)
            np.testing.assert_allclose(got.numpy(), want, atol=BF16_ATOL,
                                       rtol=BF16_ATOL)
            assert _cos(got.numpy(), want) > BF16_COS


def _treelstm_params(seed=3, **kw):
    """JAX TreeLSTM diora params and the same weights in the port."""
    dp = jax_init_params(jax.random.PRNGKey(seed),
                         JaxConfig(size=D, input_size=E, arch="treelstm",
                                   **kw), V)["diora"]
    flat = jckpt.flatten(dp)
    return dp, tckpt.params_from_numpy(flat, "cpu")


def test_leaf_and_charts_match_jax():
    """The leaf (h, c) and run_chart's inside and outside h, c and s
    charts with CKY, n=5 (tests/test_chart_pass.py:132-145)."""
    n = 5
    dp_j, dp_t = _treelstm_params()
    x = np.random.RandomState(4).randn(2, n, D).astype(np.float32)
    jcfg = JaxConfig(size=D, arch="treelstm")
    cfg = ModelConfig(size=D, arch="treelstm")
    jh0, jc0 = jdiora.leaf_transform(jcfg, dp_j, jnp.asarray(x))
    th0, tc0 = tdiora.leaf_transform(cfg, dp_t, torch.from_numpy(x))
    np.testing.assert_allclose(th0.numpy(), np.asarray(jh0), atol=CHART_ATOL)
    np.testing.assert_allclose(tc0.numpy(), np.asarray(jc0), atol=CHART_ATOL)
    assert tdiora.leaf_transform(ModelConfig(size=D), dp_t,
                                 torch.from_numpy(x))[1] is None

    want = jax.jit(functools.partial(
        jchart.run_chart, jcfg, with_cky=True, outside=True))(
        dp_j, jh0, c0=jc0)
    got = tchart.run_chart(cfg, dp_t, th0, c0=tc0, with_cky=True,
                           outside=True)
    for name in ("inside_h", "inside_c", "outside_h", "outside_c"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)),
                                   atol=CHART_ATOL, err_msg=name)
    for name in ("inside_s", "outside_s", "cky_val"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)),
                                   atol=SCORE_ATOL, err_msg=name)
    np.testing.assert_array_equal(got.cky_bp.numpy(),
                                  np.asarray(want.cky_bp))
    # cell states carry signal beyond the leaves
    assert got.inside_c[:, n:].abs().sum() > 0


def _cliora_pair(attn_impl="cuda"):
    model = dict(size=D, input_size=E, arch="treelstm", use_obj=True,
                 n_regions=R, obj_feat_size=F, attn_dropout=0.0)
    train = dict(lr=1e-3, k_neg=K, emb_trainable=True, vg_loss=True,
                 use_contr=True)
    params = jax_init_params(jax.random.PRNGKey(5), JaxConfig(**model), V)
    key = jax.random.PRNGKey(9)
    params["img_encoder"] = jax.tree.map(
        lambda x: 0.01 * jax.random.normal(key, x.shape),
        params["img_encoder"])
    return (JaxConfig(**model), jt.TrainConfig(attn_impl="chunked", **train),
            ModelConfig(**model), tt.TrainConfig(attn_impl=attn_impl, **train),
            params)


def test_cliora_losses_and_grads_match_jax():
    """One TreeLSTM CLIORA ``compute_losses`` (VG + contrastive through
    the fused span x region route) and its gradients, at the port's
    train-step limits."""
    jcfg, jtc, cfg, tc, params = _cliora_pair()
    rs = np.random.RandomState(6)
    toks = rs.randint(2, V, (B, L))
    neg = rs.choice(V, K, replace=False)
    obj = rs.randn(B, R, F).astype(np.float32)

    def loss(p):
        return jt.compute_losses(jcfg, jtc, p, jnp.asarray(toks),
                                 jnp.asarray(neg), obj_feats=jnp.asarray(obj),
                                 rng=None, train=True)

    (_, want_m), want_g = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        params)
    want_g = jckpt.flatten(want_g)
    tr = tt.Trainer(cfg, tc, tckpt.params_from_numpy(
        jckpt.flatten(params), "cpu"), device="cpu")
    total, got_m = tt.compute_losses(
        cfg, tc, tr.params, torch.as_tensor(toks), torch.as_tensor(neg),
        obj_feats=torch.as_tensor(obj), train=True)
    total.backward()
    assert set(got_m) == set(want_m)
    for k in want_m:
        np.testing.assert_allclose(float(got_m[k].detach()), float(want_m[k]),
                                   rtol=LOSS_RTOL, err_msg=k)
    got_g = {k: p.grad.numpy() for k, p in zip(tt.tree_paths(tr.params),
                                               tt.tree_leaves(tr.params))}
    assert set(got_g) == set(want_g)
    for k in want_g:
        scale = max(1.0, float(np.abs(want_g[k]).max()))
        np.testing.assert_allclose(got_g[k] / scale, want_g[k] / scale,
                                   atol=GRAD_ATOL, err_msg=k)


def test_checkpoints_cross_both_ways(tmp_path):
    """``.npz`` files of TreeLSTM params load in either package; the
    reference ``.pt`` map carries the names the reference has and, as the
    JAX package does, leaves the TreeLSTM weights (no reference name)
    out of the file and missing on import."""
    want = jax_init_params(jax.random.PRNGKey(7),
                           JaxConfig(size=D, input_size=E, arch="treelstm",
                                     share=False), V)
    cfg = ModelConfig(size=D, input_size=E, arch="treelstm", share=False)
    template = tt.Trainer.build(cfg, tt.TrainConfig(), V,
                                device="cpu").params
    flat = jckpt.flatten(want)
    assert sorted(tckpt.flatten(template)) == sorted(flat)

    jckpt.save_params(str(tmp_path / "j.npz"), want)
    got, missing = tckpt.load_params(str(tmp_path / "j.npz"), template)
    assert missing == []
    tflat = tckpt.flatten(got)
    for k in flat:
        np.testing.assert_array_equal(tflat[k], flat[k], err_msg=k)
    tckpt.save_params(str(tmp_path / "t.npz"), got)
    back, missing = jckpt.load_params(str(tmp_path / "t.npz"), want)
    assert missing == []
    for k, v in jckpt.flatten(back).items():
        np.testing.assert_array_equal(np.asarray(v), flat[k], err_msg=k)

    tckpt.export_torch_checkpoint(str(tmp_path / "t.pt"), got)
    jckpt.export_torch_checkpoint(str(tmp_path / "j.pt"), want)
    t_sd = torch.load(tmp_path / "t.pt", weights_only=True)["state_dict"]
    j_sd = torch.load(tmp_path / "j.pt", weights_only=True)["state_dict"]
    assert sorted(t_sd) == sorted(j_sd)
    _, t_missing = tckpt.import_torch_checkpoint(str(tmp_path / "j.pt"),
                                                 template)
    _, j_missing = jckpt.import_torch_checkpoint(str(tmp_path / "t.pt"),
                                                 want)
    assert sorted(t_missing) == sorted(j_missing)
    assert "diora/inside_compose/W" in t_missing


def test_padded_buckets_refuse_treelstm():
    """The outside pass with ``lengths`` refuses a TreeLSTM model, as the
    JAX package asserts."""
    dp_j, dp_t = _treelstm_params()
    x = np.random.RandomState(8).randn(2, 4, D).astype(np.float32)
    cfg, jcfg = (ModelConfig(size=D, arch="treelstm"),
                 JaxConfig(size=D, arch="treelstm"))
    msg = "padded buckets support the mlp arch only"
    with pytest.raises(AssertionError, match=msg):
        jchart.run_chart(jcfg, dp_j, *jdiora.leaf_transform(
            jcfg, dp_j, jnp.asarray(x)), lengths=jnp.array([4, 3]))
    h0, c0 = tdiora.leaf_transform(cfg, dp_t, torch.from_numpy(x))
    with pytest.raises(ValueError, match=msg):
        tchart.run_chart(cfg, dp_t, h0, c0=c0,
                         lengths=torch.tensor([4, 3]))


@pytest.mark.parametrize("arch", ["treelstm", "word"])
def test_export_refuses_non_mlp(arch):
    """A bundle's programs parse padded buckets; the JAX export fails for
    these archs, the port's raises first."""
    cfg = ModelConfig(size=D, input_size=E, arch=arch, use_obj=arch == "word",
                      n_regions=R, obj_feat_size=F)
    tr = tt.Trainer.build(cfg, tt.TrainConfig(), V, device="cpu")
    with pytest.raises(ValueError, match="mlp"):
        serving.export_parser(cfg, tr.params, [4], platforms=["cpu"])
