"""The training slice as a whole: one ``Trainer.step`` of the port vs one
``Trainer.step`` (``_train_step``) of the JAX package from identical
parameters and batch -- losses, gradients and post-Adam parameters --
for DIORA and for CLIORA under every span x region route; the eval step;
``trainable_mask``; the optax-matching clip; bf16 against f32; and the
``TrainConfig`` refusals."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from cliora_tpu.models.config import ModelConfig as JaxConfig
from cliora_tpu.models.params import init_params as jax_init_params
from cliora_tpu.training import trainer as jt
from cliora_tpu.training.checkpoint import flatten
from cliora_tpu_torch.models.config import ModelConfig
from cliora_tpu_torch.training import trainer as tt
from cliora_tpu_torch.training.checkpoint import flatten as tflatten
from cliora_tpu_torch.training.checkpoint import params_from_numpy

D, E, V, R, F, K = 16, 24, 50, 4, 32, 5
B, L = 4, 5
LR = 1e-3
JAX_ATTN = {"einsum": "einsum", "chunked": "chunked", "cuda": "pallas"}


def _configs(use_obj, attn_impl="einsum", compute_dtype="float32", **tc_kw):
    model = dict(size=D, input_size=E, compute_dtype=compute_dtype)
    if use_obj:
        model.update(use_obj=True, n_regions=R, obj_feat_size=F,
                     attn_dropout=0.0)
    train = dict(lr=LR, k_neg=K, emb_trainable=True, **tc_kw)
    if use_obj:
        train.update(vg_loss=True, use_contr=True)
    return (JaxConfig(**model),
            jt.TrainConfig(attn_impl=JAX_ATTN[attn_impl], **train),
            ModelConfig(**model), tt.TrainConfig(attn_impl=attn_impl, **train))


def _params(jcfg, seed=4):
    """JAX init, with the zero-init image encoder perturbed off the tied
    state (tests/test_span_region.py:87-98): with all-zero regions every
    score ties, and jnp.max splits a tie's gradient where the fused
    routes send it to the first max."""
    params = jax_init_params(jax.random.PRNGKey(seed), jcfg, V)
    if "img_encoder" in params:
        key = jax.random.PRNGKey(9)
        params["img_encoder"] = jax.tree.map(
            lambda x: 0.01 * jax.random.normal(key, x.shape),
            params["img_encoder"])
    return params


def _batch(use_obj, seed=0, lengths=False):
    rs = np.random.RandomState(seed)
    batch = {"sentences": rs.randint(2, V, (B, L)),
             "neg_samples": rs.choice(V, K, replace=False)}
    if use_obj:
        batch["obj_feats"] = rs.randn(B, R, F).astype(np.float32)
    if lengths:
        batch["lengths"] = np.array([5, 2, 4, 3], np.int32)
    return batch


def _port_trainer(cfg, tc, jparams):
    return tt.Trainer(cfg, tc, params_from_numpy(flatten(jparams), "cpu"),
                      device="cpu")


def _jax_grads(jcfg, jtc, params, batch):
    def loss(p):
        return jt.compute_losses(
            jcfg, jtc, p, jnp.asarray(batch["sentences"]),
            jnp.asarray(batch["neg_samples"]),
            obj_feats=(None if "obj_feats" not in batch
                       else jnp.asarray(batch["obj_feats"])),
            rng=None, train=True,
            lengths=(None if "lengths" not in batch
                     else jnp.asarray(batch["lengths"])))
    return flatten(jax.jit(jax.grad(lambda p: loss(p)[0]))(params))


def _port_grads(cfg, tc, tparams, batch):
    tr = tt.Trainer(cfg, tc, tparams, device="cpu")
    tokens, neg, obj, lengths = tr._place_batch(batch)
    total, _ = tt.compute_losses(cfg, tc, tr.params, tokens, neg,
                                 obj_feats=obj, train=True, lengths=lengths)
    total.backward()
    return {k: np.zeros_like(v) if g is None else g.numpy()
            for (k, v), g in zip(tflatten(tr.params).items(),
                                 [p.grad for p in tt.tree_leaves(tr.params)])}


@pytest.mark.parametrize("use_obj,attn_impl,lengths", [
    (False, "einsum", False),
    (True, "einsum", False),
    (True, "chunked", False),
    (True, "cuda", False),
    (True, "cuda", True),
], ids=["diora", "cliora-einsum", "cliora-chunked", "cliora-cuda",
        "cliora-cuda-lengths"])
def test_train_step_matches_jax(use_obj, attn_impl, lengths):
    """Losses at rtol 1e-4, gradients at atol 1e-5 (scaled), and the parameters
    after clip + Adam at atol 1e-3 * lr on entries whose |grad| > 1e-6:
    Adam's first step moves each entry by about lr * sign(grad), and the
    sign of a gradient at rounding level is no contract."""
    jcfg, jtc, cfg, tc = _configs(use_obj, attn_impl)
    params = _params(jcfg)
    batch = _batch(use_obj, lengths=lengths)

    want_g = _jax_grads(jcfg, jtc, params, batch)
    got_g = _port_grads(cfg, tc, params_from_numpy(flatten(params), "cpu"),
                        batch)
    assert set(got_g) == set(want_g)
    for k in want_g:
        # atol 1e-5 on each gradient over its largest entry when that
        # exceeds 1: N(0, 1) weights give O(1) leaf gradients, whose f32
        # sums differ between the packages in the sixth digit
        scale = max(1.0, float(np.abs(want_g[k]).max()))
        np.testing.assert_allclose(got_g[k] / scale, want_g[k] / scale,
                                   atol=1e-5, err_msg=f"grad {k}")

    ttr = _port_trainer(cfg, tc, params)
    # the JAX step donates (deletes) the arrays of the state it is given
    jtr = jt.Trainer(jcfg, jtc, params)
    want_m = jtr.step(batch, rng=jax.random.PRNGKey(0))
    got_m = ttr.step(batch)
    assert set(got_m) == set(want_m)
    for k in want_m:
        assert got_m[k].device.type == "cpu" and got_m[k].ndim == 0
        np.testing.assert_allclose(got_m[k].item(), float(want_m[k]),
                                   rtol=1e-4, err_msg=k)
    want_p = flatten(jtr.params)
    for k, v in tflatten(ttr.params).items():
        moved = np.abs(want_g[k]) > 1e-6
        np.testing.assert_allclose(v[moved], want_p[k][moved],
                                   atol=1e-3 * LR, err_msg=f"param {k}")


def test_eval_step_matches_jax():
    """``train=False``: the attention is materialized and ``vg_atten``
    mixes span and word scores as at eval; no parameter moves."""
    jcfg, jtc, cfg, tc = _configs(True, "cuda")
    params = _params(jcfg)
    batch = _batch(True, seed=1)
    want = jt.Trainer(jcfg, jtc, params).step(batch, train=False)
    ttr = _port_trainer(cfg, tc, params)
    before = tflatten(ttr.params)
    got = ttr.step(batch, train=False)
    for k in want:
        np.testing.assert_allclose(got[k].item(), float(want[k]), rtol=1e-4,
                                   err_msg=k)
    for k, v in tflatten(ttr.params).items():
        np.testing.assert_array_equal(v, before[k])


@pytest.mark.parametrize("freeze,emb_trainable", [
    ("none", True), ("none", False), ("diora", True), ("except_vis", False)])
def test_trainable_mask_matches_jax(freeze, emb_trainable):
    jcfg, jtc, cfg, tc = _configs(True, freeze=freeze)
    jtc = dataclasses.replace(jtc, emb_trainable=emb_trainable)
    tc = dataclasses.replace(tc, emb_trainable=emb_trainable)
    params = _params(jcfg)
    want = flatten(jt.trainable_mask(jtc, params))
    ttr = _port_trainer(cfg, tc, params)
    got = {k: bool(m) for k, m in zip(tflatten(ttr.params),
                                      tt.tree_leaves(ttr.mask))}
    assert got == {k: bool(v) for k, v in want.items()}
    # the optimizer holds the trainable parameters only, and a step moves
    # none of the frozen ones
    before = tflatten(ttr.params)
    ttr.step(_batch(True))
    assert len(ttr.optimizer.param_groups[0]["params"]) == sum(got.values())
    for k, v in tflatten(ttr.params).items():
        if not got[k]:
            np.testing.assert_array_equal(v, before[k])


@pytest.mark.parametrize("scale", [0.1, 10.0])
def test_clip_matches_optax(scale):
    """Below the limit the gradients pass unchanged; above it each is
    ``g / norm * max_norm``, optax's rule."""
    rs = np.random.RandomState(2)
    grads = [scale * rs.randn(*s).astype(np.float32)
             for s in ((3, 4), (5,), (2, 2, 2))]
    want, _ = optax.clip_by_global_norm(5.0).update(
        [jnp.asarray(g) for g in grads], None)
    got, norm = tt.clip_by_global_norm([torch.from_numpy(g) for g in grads],
                                       5.0)
    np.testing.assert_allclose(norm.item(), np.sqrt(sum(
        (g.astype(np.float64) ** 2).sum() for g in grads)), rtol=1e-6)
    for g, w, raw in zip(got, want, grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-7)
        if scale < 1:
            np.testing.assert_array_equal(g.numpy(), raw)


def test_step_clips_a_large_gradient():
    """The train batch's gradient norm is far above 5 at N(0, 1) init, so
    the step applies the clipped gradient (the Adam moments hold it)."""
    jcfg, jtc, cfg, tc = _configs(False)
    params = _params(jcfg)
    batch = _batch(False)
    raw = _port_grads(cfg, tc, params_from_numpy(flatten(params), "cpu"),
                      batch)
    norm = np.sqrt(sum((g.astype(np.float64) ** 2).sum()
                       for g in raw.values()))
    assert norm > 5.0
    ttr = _port_trainer(cfg, tc, params)
    ttr.step(batch)
    for p, k in zip(tt.tree_leaves(ttr.params), tflatten(ttr.params)):
        exp_avg = ttr.optimizer.state[p]["exp_avg"].numpy()
        np.testing.assert_allclose(exp_avg, 0.1 * raw[k] / norm * 5.0,
                                   rtol=1e-4, atol=1e-8, err_msg=k)


def test_bf16_step_tracks_f32():
    """bf16 charts against the f32 step, by the checks of
    tests/test_bf16.py: losses within 0.02 + 3 %, every nontrivial
    gradient at cosine > 0.98."""
    jcfg, _, cfg32, tc = _configs(True, "cuda")
    cfg16 = dataclasses.replace(cfg32, compute_dtype="bfloat16")
    params = _params(jcfg)
    batch = _batch(True, seed=3)
    g32 = _port_grads(cfg32, tc, params_from_numpy(flatten(params), "cpu"),
                      batch)
    g16 = _port_grads(cfg16, tc, params_from_numpy(flatten(params), "cpu"),
                      batch)
    m32 = _port_trainer(cfg32, tc, params).step(batch)
    m16 = _port_trainer(cfg16, tc, params).step(batch)
    for k in m32:
        assert abs(m16[k].item() - m32[k].item()) \
            <= 0.02 + 0.03 * abs(m32[k].item()), k
    for k in g32:
        a, b = g32[k].ravel(), g16[k].ravel()
        assert np.all(np.isfinite(b)), k
        na, nb = np.linalg.norm(a), np.linalg.norm(b)
        if na > 1e-6 and nb > 1e-6:
            assert float(a @ b / (na * nb)) > 0.98, k


def test_train_config_refusals():
    """The span x region route must be one the port has.  ZeRO-1 and
    gradient accumulation, refused until their slices landed, build
    (tests/test_torch_parallel.py, tests/test_torch_accum.py)."""
    assert tt.TrainConfig(zero1=True).zero1
    with pytest.raises(ValueError):
        tt.TrainConfig(attn_impl="pallas")
