"""Optimizer-state checkpoints that cross between the packages, exact
resume, and -- on a machine with a CUDA card -- ``Trainer.steps`` as a
replayed CUDA graph against eager steps.

Both directions start from the same weights and batches, take two steps
in one package, save Adam's state (``save_opt_state``, the JAX package's
``.opt.pkl`` format) and the parameters (``.npz``), load them into the
other package, and take a third step there, held against the third step
of an uninterrupted run in the package that saved.  The model freezes its
embeddings, so the JAX state holds a ``MaskedNode`` and its sorted-key
leaf order differs from the port's insertion order.

JAX is imported inside the JAX tests only, so this file also runs on a
machine with a card and no JAX:
``python -m pytest --noconftest tests/test_torch_opt_state.py``.
"""

import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

from cliora_tpu_torch.models.config import ModelConfig
from cliora_tpu_torch.ops import span_region
from cliora_tpu_torch.training import checkpoint as tck
from cliora_tpu_torch.training import trainer as tt
from torch_parity import port_init

D, E, V, R, F, K = 16, 24, 50, 3, 16, 5
B, L = 4, 6
LR = 1e-3
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _configs(attn_dropout=0.0):
    model = dict(size=D, input_size=E, use_obj=True, n_regions=R,
                 obj_feat_size=F, attn_dropout=attn_dropout)
    train = dict(lr=LR, k_neg=K, vg_loss=True, use_contr=True,
                 emb_trainable=False)
    return model, train


def _port_trainer(flat, attn_dropout=0.0, device="cpu"):
    model, train = _configs(attn_dropout)
    return tt.Trainer(ModelConfig(**model),
                      tt.TrainConfig(attn_impl="cuda", **train),
                      tck.params_from_numpy(flat, device), device=device)


def _batches(n, seed=3):
    rs = np.random.RandomState(seed)
    return [{"sentences": rs.randint(2, V, (B, L)),
             "neg_samples": rs.choice(V, K, replace=False),
             "obj_feats": rs.randn(B, R, F).astype(np.float32)}
            for _ in range(n)]


def _init():
    model, train = _configs()
    return port_init(ModelConfig(**model), tt.TrainConfig(**train), V, seed=6)


@pytest.fixture(scope="module")
def trip(tmp_path_factory):
    """Two steps in each package, both saved; a third step uninterrupted in
    each; each package's files loaded into the other, and a third step
    there.  One JAX trainer (one compile) serves both directions."""
    jax = pytest.importorskip("jax")
    if jax.default_backend() != "cpu":
        pytest.skip("the JAX parity tests hold the port to JAX on the CPU")
    from cliora_tpu.models.config import ModelConfig as JaxConfig
    from cliora_tpu.training import checkpoint as jck
    from cliora_tpu.training import trainer as jt
    from torch_parity import adam_moved, jax_tree

    d = tmp_path_factory.mktemp("opt_state")
    flat = _init()
    b1, b2, b3 = _batches(3)
    model, train = _configs()
    jtr = jt.Trainer(JaxConfig(**model),
                     jt.TrainConfig(attn_impl="einsum", **train),
                     jax_tree(flat))
    out = {"dir": d, "jax_template": jtr.state.opt_state}
    for b in (b1, b2):
        jtr.step(b)
    jck.save_opt_state(str(d / "jax.opt.pkl"), jtr.local_opt_state())
    jck.save_params(str(d / "jax.npz"), jtr.local_params())
    out["jax_m3"] = {k: float(v) for k, v in jtr.step(b3).items()}
    out["jax_p3"] = jck.flatten(jtr.params)
    out["jax_moved"] = adam_moved(jtr, 3)

    port = _port_trainer(flat)
    for b in (b1, b2):
        port.step(b)
    tck.save_opt_state(str(d / "port.opt.pkl"), port.opt_state())
    tck.save_params(str(d / "port.npz"), port.params)
    out["port_m3"] = {k: v.item() for k, v in port.step(b3).items()}
    out["port_p3"] = tck.flatten(port.params)

    # JAX -> port
    resumed = _port_trainer(flat)
    params, missing = tck.load_params(str(d / "jax.npz"), resumed.params)
    assert missing == []
    resumed.install_state(params, tck.load_opt_state(str(d / "jax.opt.pkl")))
    resumed.set_step(2)
    out["resumed_port_m3"] = {k: v.item()
                              for k, v in resumed.step(b3).items()}
    out["resumed_port_p3"] = tck.flatten(resumed.params)

    # port -> JAX
    params, _ = jck.load_params(str(d / "port.npz"), jtr.params)
    opt = jck.load_opt_state(str(d / "port.opt.pkl"), jtr.state.opt_state)
    jtr.install_state(params, opt)
    jtr.set_step(2)
    out["resumed_jax_m3"] = {k: float(v) for k, v in jtr.step(b3).items()}
    out["resumed_jax_p3"] = jck.flatten(jtr.params)
    out["resumed_jax_moved"] = adam_moved(jtr, 3)
    return out


def _check_third_step(got_m, got_p, want_m, want_p, moved):
    """The one-step check's tolerances (tests/test_torch_train_step.py):
    metrics at rtol 1e-4, parameters at atol 1e-3 * lr on the entries
    whose root-mean-square gradient exceeds 1e-6; the frozen embeddings
    equal."""
    assert set(got_m) == set(want_m)
    for k in want_m:
        np.testing.assert_allclose(got_m[k], want_m[k], rtol=1e-4,
                                   err_msg=k)
    assert set(got_p) == set(want_p)
    assert set(moved) == set(got_p) - {"embed/embeddings"}
    np.testing.assert_array_equal(got_p["embed/embeddings"],
                                  want_p["embed/embeddings"])
    for k, v in got_p.items():
        if k not in moved:
            continue
        np.testing.assert_allclose(v[moved[k]], want_p[k][moved[k]],
                                   atol=1e-3 * LR, err_msg=f"param {k}")


def test_jax_opt_state_resumes_in_the_port(trip):
    _check_third_step(trip["resumed_port_m3"], trip["resumed_port_p3"],
                      trip["jax_m3"], trip["jax_p3"], trip["jax_moved"])


def test_port_opt_state_resumes_in_jax(trip):
    _check_third_step(trip["resumed_jax_m3"], trip["resumed_jax_p3"],
                      trip["port_m3"], trip["port_p3"],
                      trip["resumed_jax_moved"])


def test_port_file_has_the_jax_leaves(trip):
    """The port's file, read as the JAX loader reads it, holds the JAX
    state's leaves in order: count (int32), then mu and nu of each
    trainable parameter by sorted key path (31 for this model; the frozen
    embedding table has none)."""
    import jax

    with open(trip["dir"] / "port.opt.pkl", "rb") as f:
        got = jax.tree.leaves(pickle.load(f))
    want = jax.tree.leaves(trip["jax_template"])
    assert len(got) == len(want) == 31
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
    assert int(got[0]) == 2


_LOAD_ALONE = r"""
import sys
from cliora_tpu_torch.training.checkpoint import load_opt_state
st = load_opt_state(sys.argv[1])
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "optax", "cliora_tpu"))
print(st["count"], len(st["mu"]), len(st["nu"]), bad)
"""


def test_loading_a_jax_file_imports_neither_optax_nor_jax(trip):
    out = subprocess.run(
        [sys.executable, "-c", _LOAD_ALONE,
         str(trip["dir"] / "jax.opt.pkl")],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["2", "15", "15", "[]"], out.stdout


def test_loader_refuses_other_classes(tmp_path):
    path = tmp_path / "bad.opt.pkl"
    with open(path, "wb") as f:
        pickle.dump((np.int32(0), {"a": np.zeros(2)},
                     {"a": subprocess.CompletedProcess([], 0)}), f)
    with pytest.raises(pickle.UnpicklingError, match="subprocess"):
        tck.load_opt_state(str(path))


def test_exact_resume_in_the_port(tmp_path):
    """Three steps with dropout on, saved; a fresh trainer loads the
    parameters and Adam's state and ``set_step(3)``; its fourth step has
    the bits of the uninterrupted run's (the dropout stream resumes)."""
    flat = _init()
    batches = _batches(4, seed=8)
    run = _port_trainer(flat, attn_dropout=0.1)
    run.steps(batches[:3])
    tck.save_params(str(tmp_path / "p.npz"), run.params)
    tck.save_opt_state(str(tmp_path / "p.opt.pkl"), run.opt_state())
    want = run.step(batches[3])

    other = _init()
    other = {k: v + 1.0 for k, v in other.items()}
    resumed = _port_trainer(other, attn_dropout=0.1)
    params, _ = tck.load_params(str(tmp_path / "p.npz"), resumed.params)
    before = [p.data_ptr() for p in tt.tree_leaves(resumed.params)]
    resumed.install_state(params, tck.load_opt_state(
        str(tmp_path / "p.opt.pkl")))
    resumed.set_step(3)
    # installed in place: a captured graph would still see these tensors
    assert [p.data_ptr() for p in tt.tree_leaves(resumed.params)] == before
    got = resumed.step(batches[3])
    for k in want:
        assert got[k].item() == want[k].item(), k
    want_p = tck.flatten(run.params)
    for k, v in tck.flatten(resumed.params).items():
        np.testing.assert_array_equal(v, want_p[k], err_msg=k)


def test_opt_state_is_a_snapshot():
    """``opt_state`` copies Adam's state: the next step, which updates the
    moments in place, leaves it as it was."""
    tr = _port_trainer(_init())
    st = tr.opt_state()
    tr.step(_batches(1)[0])
    assert st["count"] == 0 and tr.opt_state()["count"] == 1
    for k in st["mu"]:
        assert not st["mu"][k].any() and not st["nu"][k].any(), k


def test_install_state_refuses_a_mismatch():
    tr = _port_trainer(_init())
    st = tr.opt_state()
    st["mu"].pop("reconstruct/mat")
    with pytest.raises(ValueError, match="reconstruct/mat"):
        tr.install_state(opt_state=st)
    params = {**tr.params, "reconstruct": {"mat": np.zeros((3, 3))}}
    with pytest.raises(ValueError, match="shape"):
        tr.install_state(params=params)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the graphed step runs only there")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("attn_dropout", [0.0, 0.1])
def test_graphed_steps_match_eager(cuda, attn_dropout):
    """On the card ``steps`` warms up eagerly, captures one step and
    replays it: three replayed steps after the warm-up hold to as many
    eager ``step`` calls at the JAX package's tolerances for ``steps``
    against ``step`` (metrics rtol 1e-5, parameters atol 1e-6), with
    dropout on too (the generator replays as eager steps draw); K2-K4
    launch at the capture only."""
    flat = _init()
    batches = _batches(tt.GRAPH_WARMUP_STEPS + 3, seed=9)
    eager = _port_trainer(flat, attn_dropout, device=cuda)
    graphed = _port_trainer(flat, attn_dropout, device=cuda)
    want = [eager.step(b) for b in batches]
    got = graphed.steps(batches)
    before = dict(span_region.launches)
    again = graphed.steps(batches[:1])      # a replay only
    assert span_region.launches == before
    want.append(eager.step(batches[0]))
    for a, b in zip(want, got + again):
        for k in a:
            np.testing.assert_allclose(b[k].item(), a[k].item(), rtol=1e-5,
                                       err_msg=k)
    want_p = tck.flatten(eager.params)
    for k, v in tck.flatten(graphed.params).items():
        np.testing.assert_allclose(v, want_p[k], atol=1e-6, err_msg=k)


def test_failed_capture_leaves_the_allocator_free(cuda, monkeypatch):
    """A capture that fails (a host sync inside the step) raises, and
    leaves neither its capture stream current nor the caching allocator
    routing to the graph's pool: memory freed afterwards goes back to the
    device on ``empty_cache``, and the next call captures."""
    tr = _port_trainer(_init(), device=cuda)
    batches = _batches(tt.GRAPH_WARMUP_STEPS + 2, seed=4)
    tr.steps(batches[:tt.GRAPH_WARMUP_STEPS])
    clip = tt.clip_by_global_norm

    def syncing_clip(grads, max_norm):
        clipped, norm = clip(grads, max_norm)
        float(norm)
        return clipped, norm

    stream = torch.cuda.current_stream()
    monkeypatch.setattr(tt, "clip_by_global_norm", syncing_clip)
    with pytest.raises(RuntimeError, match="capture"):
        tr.steps(batches[-2:-1])
    monkeypatch.setattr(tt, "clip_by_global_norm", clip)
    assert torch.cuda.current_stream() == stream
    torch.empty(1 << 30, dtype=torch.uint8, device=cuda)
    cached = torch.cuda.memory_reserved()
    torch.cuda.empty_cache()
    assert cached - torch.cuda.memory_reserved() >= 1 << 30
    retry = tr.steps(batches[-1:])[0]
    assert all(np.isfinite(float(v)) for v in retry.values())
