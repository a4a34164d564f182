"""Sharded async checkpoints of the port (training/dist_ckpt.py, the
``torch.distributed.checkpoint`` counterpart of
cliora_tpu/training/orbax_ckpt.py; the counterparts of
tests/test_orbax.py).

A trainer's parameters, Adam's state and step counters go to a DCP
directory and come back into a fresh trainer in place; a resumed
trajectory has the uninterrupted one's bits; ``AsyncSaver`` keeps one
write in flight and has the state in host memory before ``save``
returns, so a step right after a save does not reach the checkpoint; a
ZeRO-1 state saved by two ranks (each its slice) restores into one
process, resharded.  Through the train CLI, ``--ckpt_backend orbax``
writes ``model.epoch_N.dcp`` directories that ``--resume`` and
``--resume auto`` read and ``--ckpt_keep`` prunes.
"""

import os

import numpy as np
import pytest

import torch_dp as dp
from cliora_tpu_torch.scripts import train as port_train
from cliora_tpu_torch.training.checkpoint import flatten
from cliora_tpu_torch.training.dist_ckpt import (
    AsyncSaver,
    is_ckpt_dir,
    restore_state,
    save_state,
)

NAMES = ["cliora", "cliora_zero1"]


def _state(tr):
    return flatten(tr.params), tr.opt_state(), tr._host_step


def _assert_state_equal(a, b):
    (fa, oa, sa), (fb, ob, sb) = a, b
    assert fa.keys() == fb.keys() and sa == sb
    for k in fa:
        np.testing.assert_array_equal(fa[k], fb[k], err_msg=k)
    assert oa["count"] == ob["count"]
    for part in ("mu", "nu"):
        assert oa[part].keys() == ob[part].keys()
        for k in oa[part]:
            np.testing.assert_array_equal(oa[part][k], ob[part][k],
                                          err_msg=f"{part} {k}")


@pytest.mark.parametrize("name", NAMES)
def test_roundtrip(name, tmp_path):
    tr = dp.trainer(name)
    tr.step(dp.batches(name)[0])
    path = str(tmp_path / "state.dcp")
    save_state(path, tr)
    assert is_ckpt_dir(path)
    tr2 = dp.trainer(name)
    restore_state(path, tr2)
    _assert_state_equal(_state(tr), _state(tr2))


@pytest.mark.parametrize("name", NAMES)
def test_resume_trajectory_bit_identical(name, tmp_path):
    """Save after two steps, restore into a fresh trainer: the next steps
    (dropout on) have the uninterrupted run's bits."""
    name = name.replace("cliora", "cliora_dropout")
    batches = dp.batches(name, steps=4)
    tr = dp.trainer(name)
    for b in batches[:2]:
        tr.step(b)
    path = str(tmp_path / "mid.dcp")
    save_state(path, tr)
    tr2 = dp.trainer(name)
    restore_state(path, tr2)
    for b in batches[2:]:
        m1, m2 = tr.step(b), tr2.step(b)
        for k in m1:
            assert float(m1[k]) == float(m2[k]), k
    _assert_state_equal(_state(tr), _state(tr2))


def test_async_saver(tmp_path):
    """Two saves through one ``AsyncSaver``, each followed at once by a
    step that writes the parameters in place: each directory holds the
    state at its ``save``."""
    tr = dp.trainer("cliora")
    batches = dp.batches("cliora", steps=4)
    states = []
    with AsyncSaver() as saver:
        for epoch in range(2):
            tr.step(batches[2 * epoch])
            states.append(_state(tr))
            saver.save(str(tmp_path / f"e{epoch}.dcp"), tr)
            tr.step(batches[2 * epoch + 1])
        saver.wait()
    for epoch in range(2):
        tr2 = dp.trainer("cliora")
        restore_state(str(tmp_path / f"e{epoch}.dcp"), tr2)
        _assert_state_equal(states[epoch], _state(tr2))


def test_is_ckpt_dir_negatives(tmp_path):
    assert not is_ckpt_dir(str(tmp_path))               # a plain dir
    p = tmp_path / "model.npz"
    p.write_bytes(b"x")
    assert not is_ckpt_dir(str(p))                      # a file
    assert not is_ckpt_dir(str(tmp_path / "missing.dcp"))


@pytest.fixture(scope="module")
def saved_by_two_ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("ck")
    return out, dp.launch(out, "dist_ckpt", world=2)


@pytest.mark.parametrize("name", NAMES)
def test_restore_at_another_world_size(name, saved_by_two_ranks):
    """A ZeRO-1 state written by two ranks (one ``.distcp`` file each)
    restores into one process, ZeRO-1 or replicated: the state equals
    the saved one bit for bit."""
    out, recs = saved_by_two_ranks
    path = str(out / "zero1.dcp")
    assert sorted(f for f in os.listdir(path) if f.endswith(".distcp")) \
        == ["__0_0.distcp", "__1_0.distcp"]
    tr = dp.trainer(name)
    restore_state(path, tr)
    flat, opt, step = _state(tr)
    rec = recs[0]
    assert step == 2 and opt["count"] == int(rec["saved/opt/count"]) == 2
    for k, v in flat.items():
        np.testing.assert_array_equal(v, rec[f"saved/param/{k}"], err_msg=k)
    for part in ("mu", "nu"):
        for k, v in opt[part].items():
            np.testing.assert_array_equal(v, rec[f"saved/opt/{part}/{k}"],
                                          err_msg=f"{part} {k}")


@pytest.fixture
def corpus(tmp_path, monkeypatch):
    for var in ("MASTER_ADDR", "WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    root = str(tmp_path / "corpus")
    dp.write_corpus(root)
    return root


def test_cli_orbax_backend_and_resume(corpus, tmp_path):
    """``--ckpt_backend orbax`` writes per-epoch DCP directories (no
    ``.npz`` triplets) and the chief's keep-best ``.npz``; ``--resume``
    of a directory and ``--resume auto`` continue to the uninterrupted
    run's bits."""
    def args(exp, epochs, *extra):
        return dp.cli_flags(corpus, ["--ckpt_backend", "orbax",
                                     "--experiment_path", str(exp),
                                     "--max_epoch", str(epochs), *extra])

    full = tmp_path / "full"
    want, _ = port_train.main(args(full, 2))
    for e in (0, 1):
        assert is_ckpt_dir(str(full / f"model.epoch_{e}.dcp"))
        assert not (full / f"model.epoch_{e}.npz").exists()
    assert (full / "model.best.npz").exists()
    assert (full / "experiment.epoch_1.json").exists()

    auto = tmp_path / "auto"
    port_train.main(args(auto, 1))
    got, records = port_train.main(args(auto, 2, "--resume", "auto"))
    assert [r["epoch"] for r in records] == [1]
    _assert_state_equal(_state(want), _state(got))
    got, _ = port_train.main(args(tmp_path / "explicit", 2, "--resume",
                                  str(full / "model.epoch_0.dcp")))
    _assert_state_equal(_state(want), _state(got))
    restore_state(str(full / "model.epoch_1.dcp"), got)
    _assert_state_equal(_state(want), _state(got))


def test_ckpt_keep_prunes_dcp_dirs(corpus, tmp_path):
    """``--ckpt_keep 1`` removes the older epochs' directories."""
    exp = tmp_path / "exp"
    port_train.main(dp.cli_flags(corpus, [
        "--ckpt_backend", "orbax", "--ckpt_keep", "1",
        "--experiment_path", str(exp), "--max_epoch", "3"]))
    assert not (exp / "model.epoch_0.dcp").exists()
    assert not (exp / "model.epoch_1.dcp").exists()
    assert is_ckpt_dir(str(exp / "model.epoch_2.dcp"))
