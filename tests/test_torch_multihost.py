"""The port's multi-process initialization and what runs across processes
(the counterparts of tests/test_multihost.py), on the CPU over gloo.

``initialize_multihost`` is held to the JAX package's contract: a no-op
for one process and for unrelated environment, the launcher's topology
forwarded to ``init_process_group``, a clear error naming what an
incomplete topology lacks.  Real two-process runs (tests/torch_dp.py
workers, which import torch and the port only): the rendezvous,
``Trainer.steps`` against ``Trainer.step`` and against one process, the
distributed ``run_eval`` against one process (standing in for
``__graft_entry__.dryrun_multichip``), and the train CLI with
``--zero1`` from two epochs to a resume on both ranks.
"""

import os

import numpy as np
import pytest
import torch
import torch.distributed as dist

import torch_dp as dp
from cliora_tpu_torch.analysis.eval import run_eval
from cliora_tpu_torch.parallel import multihost
from cliora_tpu_torch.parallel.mesh import make_mesh
from cliora_tpu_torch.parallel.multihost import initialize_multihost, is_chief

TOPOLOGY = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK")


@pytest.fixture
def no_topology(monkeypatch):
    for var in TOPOLOGY:
        monkeypatch.delenv(var, raising=False)
    assert not dist.is_initialized()


@pytest.fixture
def captured(monkeypatch, no_topology):
    """``init_process_group`` replaced by a recorder."""
    calls = []

    def fake_init(backend, init_method=None, world_size=None, rank=None):
        calls.append({"backend": backend, "init_method": init_method,
                      "world_size": world_size, "rank": rank})

    monkeypatch.setattr(dist, "init_process_group", fake_init)
    return calls


def test_noop_single_process(no_topology):
    """No arguments and no launcher environment: nothing is joined."""
    assert initialize_multihost(device="cpu") is False
    assert initialize_multihost(num_processes=1, device="cpu") is False
    assert not dist.is_initialized()
    assert is_chief()


def test_noop_ignores_unrelated_env(monkeypatch, no_topology):
    """A world size without a coordinator is not a launch."""
    monkeypatch.setenv("WORLD_SIZE", "4")
    monkeypatch.setenv("RANK", "2")
    assert initialize_multihost(device="cpu") is False
    assert not dist.is_initialized()


def test_env_topology_forwarded(monkeypatch, captured):
    """torch.distributed.run's environment reaches ``init_process_group``
    (gloo for the CPU); explicit arguments win over it."""
    for var, value in (("MASTER_ADDR", "10.0.0.1"), ("MASTER_PORT", "1234"),
                       ("WORLD_SIZE", "4"), ("RANK", "2")):
        monkeypatch.setenv(var, value)
    assert initialize_multihost(device="cpu")
    assert captured[-1] == {"backend": "gloo",
                            "init_method": "tcp://10.0.0.1:1234",
                            "world_size": 4, "rank": 2}
    assert initialize_multihost("host:9", 2, 1, device="cpu")
    assert captured[-1] == {"backend": "gloo", "init_method": "tcp://host:9",
                            "world_size": 2, "rank": 1}


def test_cuda_rank_takes_its_card(monkeypatch, captured):
    """A CUDA rank makes LOCAL_RANK's card current before the group
    exists, joins over NCCL, checks that no other rank shares the card
    and makes the communicator; a local rank past the cards raises."""
    seen = []
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "set_device", seen.append)
    monkeypatch.setattr(multihost, "_refuse_shared_cards", seen.append)
    monkeypatch.setattr(multihost, "_first_collective", seen.append)
    monkeypatch.setenv("LOCAL_RANK", "1")
    assert initialize_multihost("host:9", 2, 1)
    assert captured[-1]["backend"] == "nccl"
    assert seen == [1, torch.device("cuda", 1), torch.device("cuda", 1)]
    monkeypatch.setenv("LOCAL_RANK", "2")
    with pytest.raises(RuntimeError, match="no card"):
        initialize_multihost("host:9", 3, 2)


def test_shared_card_refused(monkeypatch):
    """Two ranks whose cards have one UUID: a clear error, no NCCL
    attempt."""
    class Store:
        def __init__(self):
            self.kv = {"cliora_tpu_torch/card/1": b"GPU-same"}

        def set(self, k, v):
            self.kv[k] = v.encode()

        def get(self, k):
            return self.kv[k]

    class Props:
        uuid = "GPU-same"

    monkeypatch.setattr(dist, "get_rank", lambda *a, **k: 0)
    monkeypatch.setattr(dist, "get_world_size", lambda *a, **k: 2)
    monkeypatch.setattr(dist.distributed_c10d, "_get_default_store", Store)
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda card: Props())
    with pytest.raises(RuntimeError, match=r"ranks \[0, 1\] share one card"):
        multihost._refuse_shared_cards(torch.device("cuda", 0))


def test_incomplete_topology_error_is_clear(captured):
    """torch detects no cluster: a missing piece is named, and nothing is
    joined."""
    with pytest.raises(ValueError, match="RANK"):
        initialize_multihost("host:9", 4, None, device="cpu")
    with pytest.raises(ValueError, match="WORLD_SIZE"):
        initialize_multihost("host:9", None, 0, device="cpu")
    assert captured == []


def test_n_devices_needs_a_group(no_topology):
    """More than one device without a process group names the launch
    command; one device without a group is no mesh."""
    with pytest.raises(ValueError, match="torch.distributed.run"):
        make_mesh(2)
    with pytest.raises(ValueError, match="initialized process group"):
        make_mesh()


@pytest.fixture(scope="module")
def multihost_run(tmp_path_factory):
    return dp.launch(tmp_path_factory.mktemp("mh"), "multihost", world=2)


def test_two_process_rendezvous(multihost_run):
    """Both ranks meet, a second init is a no-op, an all-reduce sums both
    ranks' values, and rank 0 is the chief."""
    for rank, rec in enumerate(multihost_run):
        assert int(rec["rank"]) == rank
        assert bool(rec["is_chief"]) == (rank == 0)
        np.testing.assert_array_equal(rec["all_reduce"], [3.0, 3.0])


def test_two_process_steps(multihost_run):
    """``Trainer.steps`` on two CPU ranks (eager steps, with the
    collectives) leaves the state of as many ``Trainer.step`` calls, and
    both equal one process on the global batches (the parallel tests'
    tolerances)."""
    losses, names, flat, opt, _ = dp.run_case("cliora")
    moved = {k: np.sqrt(v / (1 - 0.999 ** dp.STEPS)) > 1e-6
             for k, v in opt["nu"].items()}
    for rec in multihost_run:
        np.testing.assert_array_equal(rec["steps_True/losses"],
                                      rec["steps_False/losses"])
        np.testing.assert_allclose(rec["steps_True/losses"], losses,
                                   rtol=1e-5)
        for k, v in flat.items():
            np.testing.assert_array_equal(rec[f"steps_True/param/{k}"],
                                          rec[f"steps_False/param/{k}"])
            m = moved[k]
            np.testing.assert_allclose(rec[f"steps_True/param/{k}"][m],
                                       v[m], atol=1e-5, err_msg=k)


def test_two_process_run_eval(multihost_run):
    """``run_eval`` on two ranks (each parses every second evaluable
    batch of an odd count, the counters summed) returns on both ranks
    exactly what one process computes over every batch."""
    tr = dp.run_case("diora")[-1]
    want = run_eval(tr, dp.ListIterator(dp.eval_batches()))
    assert want["corpus_f1"] > 0
    for rec in multihost_run:
        got = {k[len("eval/"):]: float(v) for k, v in rec.items()
               if k.startswith("eval/")}
        assert got == want


def test_two_process_cli_zero1(tmp_path):
    """The train CLI in two processes (``--world_size 2 --local_rank R``,
    ``--zero1 --device cpu``): two epochs with the chief's per-epoch
    files and keep-best, then both ranks resume from epoch 0's files and
    train epoch 1 to the uninterrupted run's bits."""
    dp.write_corpus(str(tmp_path / "corpus"))
    recs = dp.launch(tmp_path, "cli", world=2)
    exp1, exp2 = tmp_path / "exp1", tmp_path / "exp2"
    for name in ("model.epoch_0.npz", "model.epoch_1.npz", "model.best.npz",
                 "model.best.pt", "model.epoch_1.opt.pkl",
                 "experiment.epoch_1.json", "experiment.log",
                 "experiment.log.1"):
        assert (exp1 / name).exists(), name
    assert not (exp2 / "model.epoch_0.npz").exists()
    for rec in recs:
        np.testing.assert_array_equal(rec["epochs"], [0, 1, 1])
        assert rec["f1"][1] == rec["f1"][2]
    a = np.load(exp1 / "model.epoch_1.npz")
    b = np.load(exp2 / "model.epoch_1.npz")
    assert sorted(a.files) == sorted(b.files)
    for k in a.files:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert (open(exp1 / "model.epoch_1.opt.pkl", "rb").read()
            == open(exp2 / "model.epoch_1.opt.pkl", "rb").read())
    assert os.path.getsize(exp1 / "model.epoch_1.opt.pkl") > 0


def test_bare_cuda_is_the_current_card(monkeypatch):
    """A trainer on ``"cuda"`` or on no device given lands on the current
    card (the rank's, which ``initialize_multihost`` made current), not
    on card 0 in every rank (ROADMAP C3)."""
    from cliora_tpu_torch.training import trainer as tt

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 1)
    assert tt._resolve_device("cuda") == torch.device("cuda", 1)
    assert tt._resolve_device(None) == torch.device("cuda", 1)
    assert tt._resolve_device("cuda:0") == torch.device("cuda", 0)
    assert tt._resolve_device("cpu") == torch.device("cpu")
