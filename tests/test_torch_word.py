"""The chart-free ``--arch word`` grounding baseline of the port against
the JAX package on the same weights: ``word_grounding_forward``, one
train step's loss, gradients and updated parameters, the parse (grounding
scores, no trees) and ``run_eval``; the chart-free parameter tree and
its ``.npz`` trips; a short descent (tests/test_training.py:156-185);
and the refusals of the config and the parse scripts.  f32."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cliora_tpu.analysis.eval import run_eval as jax_run_eval
from cliora_tpu.models.config import ModelConfig as JaxConfig
from cliora_tpu.models.params import init_params as jax_init_params
from cliora_tpu.models.word_grounding import (
    word_grounding_forward as jax_word_forward,
)
from cliora_tpu.training import checkpoint as jckpt
from cliora_tpu.training import trainer as jt
from cliora_tpu_torch.analysis.eval import run_eval
from cliora_tpu_torch.models.config import ModelConfig
from cliora_tpu_torch.models.word_grounding import word_grounding_forward
from cliora_tpu_torch.scripts import parse as tparse
from cliora_tpu_torch.scripts import parse_diora as tparse_diora
from cliora_tpu_torch.training import checkpoint as tckpt
from cliora_tpu_torch.training import trainer as tt
from cliora_tpu_torch.utils import flags as tflags

D, E, V, R, F, K = 16, 24, 50, 4, 32, 5
B, L = 4, 6
LR = 1e-2


def _configs():
    model = dict(size=D, input_size=E, arch="word", use_obj=True,
                 n_regions=R, obj_feat_size=F)
    train = dict(lr=LR, k_neg=K, vg_loss=True, emb_trainable=True)
    return (JaxConfig(**model), jt.TrainConfig(**train),
            ModelConfig(**model), tt.TrainConfig(**train))


def _params(seed=0):
    """JAX init of the word tree, its zero image encoder moved off the
    tied state (all-zero regions score every word alike)."""
    jcfg = _configs()[0]
    params = jax_init_params(jax.random.PRNGKey(seed), jcfg, V)
    key = jax.random.PRNGKey(9)
    params["img_encoder"] = jax.tree.map(
        lambda x: 0.01 * jax.random.normal(key, x.shape),
        params["img_encoder"])
    return params


def _batch(seed=0, length=L):
    rs = np.random.RandomState(seed)
    return {"sentences": rs.randint(2, V, (B, length)),
            "neg_samples": rs.choice(V, K, replace=False),
            "obj_feats": rs.randn(B, R, F).astype(np.float32)}


def _port(params):
    _, _, cfg, tc = _configs()
    return tt.Trainer(cfg, tc, tckpt.params_from_numpy(
        jckpt.flatten(params), "cpu"), device="cpu")


def test_word_grounding_forward_matches_jax():
    rs = np.random.RandomState(1)
    x = rs.randn(3, 5, D).astype(np.float32)
    obj = rs.randn(3, R, D).astype(np.float32)
    want = jax_word_forward(jnp.asarray(x), jnp.asarray(obj))
    got = word_grounding_forward(torch.from_numpy(x), torch.from_numpy(obj))
    assert tuple(got.vg_atten_score.shape) == (3, 3, 5, R)
    for name in ("vg_atten_score", "atten_score"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)),
                                   rtol=1e-6, atol=1e-5, err_msg=name)


def test_word_tree_is_chart_free_and_crosses(tmp_path):
    """No ``diora`` or ``reconstruct`` subtree (tests/test_training.py:165);
    ``.npz`` files cross both ways."""
    want = _params()
    _, _, cfg, tc = _configs()
    tr = tt.Trainer.build(cfg, tc, V, device="cpu")
    assert sorted(tr.params) == sorted(want) == ["embed", "img_encoder"]
    jckpt.save_params(str(tmp_path / "j.npz"), want)
    got, missing = tckpt.load_params(str(tmp_path / "j.npz"), tr.params)
    assert missing == []
    tckpt.save_params(str(tmp_path / "t.npz"), got)
    back, missing = jckpt.load_params(str(tmp_path / "t.npz"), want)
    assert missing == []
    flat = jckpt.flatten(want)
    for k, v in jckpt.flatten(back).items():
        np.testing.assert_array_equal(np.asarray(v), flat[k], err_msg=k)


def test_word_step_matches_jax():
    """Loss and gradients of one ``word`` step at the port's train-step
    limits, and the parameters after clip + Adam."""
    jcfg, jtc, cfg, tc = _configs()
    params = _params(2)
    batch = _batch(2)
    args = (jnp.asarray(batch["sentences"]), jnp.asarray(batch["neg_samples"]))

    def loss(p):
        return jt.compute_losses(jcfg, jtc, p, *args,
                                 obj_feats=jnp.asarray(batch["obj_feats"]),
                                 rng=None, train=True)[0]

    want_g = jckpt.flatten(jax.jit(jax.grad(loss))(params))
    ttr = _port(params)
    tokens, neg, obj, _ = ttr._place_batch(batch)
    total, m = tt.compute_losses(cfg, tc, ttr.params, tokens, neg,
                                 obj_feats=obj, train=True)
    assert set(m) == {"vg_loss", "total_loss"}
    total.backward()
    for k, p in zip(tt.tree_paths(ttr.params), tt.tree_leaves(ttr.params)):
        got = np.zeros_like(want_g[k]) if p.grad is None else p.grad.numpy()
        scale = max(1.0, float(np.abs(want_g[k]).max()))
        np.testing.assert_allclose(got / scale, want_g[k] / scale,
                                   atol=1e-5, err_msg=k)

    ttr = _port(params)
    jtr = jt.Trainer(jcfg, jtc, params)
    want_m = jtr.step(batch, rng=jax.random.PRNGKey(0))
    got_m = ttr.step(batch)
    for k in want_m:
        np.testing.assert_allclose(got_m[k].item(), float(want_m[k]),
                                   rtol=1e-4, err_msg=k)
    want_p = jckpt.flatten(jtr.params)
    for k, v in tckpt.flatten(ttr.params).items():
        moved = np.abs(want_g[k]) > 1e-6
        np.testing.assert_allclose(v[moved], want_p[k][moved],
                                   atol=1e-3 * LR, err_msg=f"param {k}")


class _Iterator:
    def __init__(self, batches):
        self.batches = batches

    def get_iterator(self, random_seed=None):
        return iter(self.batches)


def _eval_batch(seed):
    """A uniform batch map with gold spans, ``VG_GT`` phrases and boxes;
    each phrase's gold box is one of its image's boxes."""
    rs = np.random.RandomState(seed)
    batch = _batch(seed)
    lo = rs.uniform(0, 50, (B, R, 2))
    boxes = np.concatenate([lo, lo + rs.uniform(10, 50, (B, R, 2))], -1)
    vg = []
    for b in range(B):
        phrases = {}
        for p in range(3):
            start = rs.randint(0, L)
            phrases[f"p{p}"] = (start, min(L, start + 1 + rs.randint(0, 3)),
                                boxes[b, rs.randint(0, R)].tolist())
        vg.append((phrases, None))
    batch.update({"GT": [[(0, L - 1)]] * B, "VG_GT": vg,
                  "boxes": boxes.astype(np.float32), "length": L,
                  "batch_size": B, "real_size": B})
    return batch


def test_word_parse_and_eval_match_jax():
    """``parse`` returns the per-example word x region scores and no
    ``cky_bp``, with the VG loss only under ``compute_loss``; ``run_eval``
    grounds with them and decodes nothing, as the JAX one does."""
    jcfg, jtc, _, _ = _configs()
    params = _params(3)
    jtr, ttr = jt.Trainer(jcfg, jtc, params), _port(params)
    batch = _eval_batch(3)
    want, want_m = jtr.parse(batch, compute_loss=True)
    got, got_m = ttr.parse(batch, compute_loss=True)
    assert set(got) == {"atten_score", "parse_impl"}
    assert got["parse_impl"] == "plain"
    assert got["atten_score"].shape == (B, L, R)
    np.testing.assert_allclose(got["atten_score"], want["atten_score"],
                               rtol=1e-6, atol=1e-5)
    assert set(got_m) == set(want_m) == {"vg_loss", "total_loss"}
    for k in want_m:
        np.testing.assert_allclose(got_m[k], want_m[k], rtol=1e-4)
    assert ttr.parse(batch)[1] == {}

    it = _Iterator([batch, _eval_batch(4)])
    want_e = jax_run_eval(jtr, it, use_obj=True)
    got_e = run_eval(ttr, it, use_obj=True)
    assert got_e["grounding_acc"] == want_e["grounding_acc"] > 0
    assert got_e["corpus_f1"] == want_e["corpus_f1"] == 0.0


def test_word_baseline_descends():
    """The VG InfoNCE over B=4 images starts at ln 4; overfitting one
    batch drives it well below (tests/test_training.py:156-185)."""
    _, _, cfg, tc = _configs()
    tr = tt.Trainer.build(cfg, tc, V, seed=0, device="cpu")
    batch = _batch(5)
    losses = [float(tr.step(batch)["total_loss"]) for _ in range(30)]
    assert np.isfinite(losses).all()
    assert abs(losses[0] - np.log(B)) < 1e-3
    assert np.mean(losses[-5:]) < 0.5 * np.log(B), losses
    # the graphed route's CPU form (eager steps) leaves the same state
    tr2 = tt.Trainer.build(cfg, tc, V, seed=0, device="cpu")
    got = tr2.steps([batch] * 30)
    assert [float(m["total_loss"]) for m in got] == losses


def test_word_needs_obj_feats():
    with pytest.raises(ValueError, match="obj_feats"):
        ModelConfig(arch="word")


@pytest.mark.parametrize("script", [tparse, tparse_diora])
def test_parse_scripts_refuse_word(script, tmp_path):
    """The parse scripts decode trees, which the word baseline has none of
    (the JAX scripts fail on the missing ``cky_bp``)."""
    options = tflags.parse_args(tflags.argument_parser(), [
        "--arch", "word", "--obj_feats", "--experiment_path",
        str(tmp_path)])
    with pytest.raises(ValueError, match="--arch word"):
        script.run(options)
