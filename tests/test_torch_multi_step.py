"""K train steps: the port's ``Trainer.steps(3)`` against the JAX package's
``Trainer.steps(3)`` (one ``lax.scan`` dispatch) from identical parameters
and batches, for a CLIORA model (VG + contrastive) and a DIORA model --
the first check of Adam past its first step -- and against three of the
port's own ``Trainer.step`` calls.  On the CPU ``steps`` runs eager
steps; its CUDA-graph route is held against ``step`` on the card
(tests/test_torch_opt_state.py and chip_smoke.py)."""

import dataclasses

import jax
import numpy as np
import pytest

from cliora_tpu.models.config import ModelConfig as JaxConfig
from cliora_tpu.training import trainer as jt
from cliora_tpu.training.checkpoint import flatten
from cliora_tpu_torch.models.config import ModelConfig
from cliora_tpu_torch.training import trainer as tt
from cliora_tpu_torch.training.checkpoint import flatten as tflatten
from cliora_tpu_torch.training.checkpoint import params_from_numpy
from torch_parity import adam_moved, jax_tree, port_init

D, E, V, R, F, K = 16, 24, 50, 3, 16, 5
B, L = 4, 6
LR = 1e-3
STEPS = 3


def _configs(use_obj):
    model = dict(size=D, input_size=E)
    if use_obj:
        model.update(use_obj=True, n_regions=R, obj_feat_size=F,
                     attn_dropout=0.0)
    train = dict(lr=LR, k_neg=K, emb_trainable=True)
    if use_obj:
        train.update(vg_loss=True, use_contr=True)
    return (JaxConfig(**model), jt.TrainConfig(attn_impl="einsum", **train),
            ModelConfig(**model), tt.TrainConfig(attn_impl="cuda", **train))


def _batches(use_obj):
    rs = np.random.RandomState(3)
    out = []
    for _ in range(STEPS):
        b = {"sentences": rs.randint(2, V, (B, L)),
             "neg_samples": rs.choice(V, K, replace=False)}
        if use_obj:
            b["obj_feats"] = rs.randn(B, R, F).astype(np.float32)
        out.append(b)
    return out


def _port(cfg, tc, flat):
    return tt.Trainer(cfg, tc, params_from_numpy(flat, "cpu"), device="cpu")


@pytest.mark.parametrize("use_obj", [True, False], ids=["cliora", "diora"])
def test_steps_match_jax_steps(use_obj):
    """Losses of each step at rtol 1e-4; parameters after three clipped
    Adam steps at atol 1e-3 * lr, on the entries whose root-mean-square
    gradient (Adam's bias-corrected second moment in the JAX state)
    exceeds 1e-6 -- the one-step check's tolerances
    (tests/test_torch_train_step.py): Adam moves an entry by about lr a
    step whatever its gradient's size, so the sign of a gradient at
    rounding level is no contract."""
    jcfg, jtc, cfg, tc = _configs(use_obj)
    params = port_init(cfg, tc, V, seed=5)
    batches = _batches(use_obj)

    ttr = _port(cfg, tc, params)
    got = ttr.steps(batches)
    jtr = jt.Trainer(jcfg, jtc, jax_tree(params))
    want = jtr.steps(batches)

    assert len(got) == len(want) == STEPS
    assert ttr._host_step == STEPS
    for i, (g, w) in enumerate(zip(got, want)):
        assert set(g) == set(w)
        for k in w:
            assert g[k].ndim == 0
            np.testing.assert_allclose(g[k].item(), float(w[k]), rtol=1e-4,
                                       err_msg=f"step {i} {k}")
    moved = adam_moved(jtr, STEPS)
    want_p = flatten(jtr.params)
    for k, v in tflatten(ttr.params).items():
        np.testing.assert_allclose(v[moved[k]], want_p[k][moved[k]],
                                   atol=1e-3 * LR, err_msg=f"param {k}")


def test_steps_match_sequential_steps():
    """``steps(3)`` leaves the state of three ``step`` calls, dropout on:
    the metrics within rtol 1e-5 and the parameters within atol 1e-6, the
    JAX package's tolerances for its ``steps`` against ``step``
    (tests/test_training.py:122-155); the step counter advances by 3."""
    _, _, cfg, tc = _configs(True)
    cfg = dataclasses.replace(cfg, attn_dropout=0.1)
    params = port_init(cfg, tc, V, seed=5)
    batches = _batches(True)
    seq_tr, grp_tr = _port(cfg, tc, params), _port(cfg, tc, params)
    seq = [seq_tr.step(b) for b in batches]
    grouped = grp_tr.steps(batches)
    assert grp_tr._host_step == seq_tr._host_step == STEPS
    for a, b in zip(seq, grouped):
        for k in a:
            np.testing.assert_allclose(a[k].item(), b[k].item(), rtol=1e-5,
                                       err_msg=k)
    want = tflatten(seq_tr.params)
    for k, v in tflatten(grp_tr.params).items():
        np.testing.assert_allclose(v, want[k], atol=1e-6, err_msg=k)
    for (_, p), (_, q) in zip(seq_tr._trainable(), grp_tr._trainable()):
        assert float(seq_tr.optimizer.state[p]["step"]) == STEPS
        assert float(grp_tr.optimizer.state[q]["step"]) == STEPS


def test_steps_refuse_mixed_shapes():
    """Like the JAX ``steps``, one call takes one batch shape."""
    _, _, cfg, tc = _configs(False)
    ttr = _port(cfg, tc, port_init(cfg, tc, V, seed=5))
    batches = _batches(False)
    batches[1] = {**batches[1], "sentences": batches[1]["sentences"][:, :4]}
    with pytest.raises(ValueError, match="one shape"):
        ttr.steps(batches)
    with pytest.raises(ValueError):
        ttr.steps([])
    assert ttr._host_step == 0
