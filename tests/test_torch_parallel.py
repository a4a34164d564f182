"""Data-parallel training of the port on the CPU (the dp and ZeRO-1 cases
of tests/test_parallel.py).

Two gloo ranks (subprocesses that import torch and the port only,
tests/torch_dp.py) train each case for three steps on their halves of
global batches of 8 rows; this process holds them against the port's
one-process step on the whole batches and against the JAX package's
``Trainer`` over ``make_mesh(2)`` on the conftest's virtual devices.

* The losses are the global batch's (the VG and contrastive negatives
  span both ranks' rows, the reconstruction mean divides by the global
  word count): rtol 1e-5, the JAX dp test's tolerance.
* The parameters after three steps: atol 1e-5 against one process on
  every entry whose root-mean-square gradient exceeds 1e-6, and the same
  against JAX.  Adam moves an entry by about lr a step whatever the size
  of its gradient, so an entry whose gradient is rounding noise carries
  no contract between two summation orders (tests/torch_parity.py
  ``adam_moved``): in these cases that is ``img_encoder/fc_vis/b``,
  whose VG gradient cancels exactly (a bias shared by every image does
  not move the softmax over images).
* One rank in a group equals no group bit for bit.
"""

import numpy as np
import pytest

import torch_dp as dp
from cliora_tpu.models.config import ModelConfig as JaxConfig
from cliora_tpu.parallel.mesh import make_mesh as jax_make_mesh
from cliora_tpu.training import trainer as jt
from cliora_tpu.training.checkpoint import flatten as jflatten
from cliora_tpu_torch.parallel.mesh import Mesh, dp_size, shard_batch
from cliora_tpu_torch.training.checkpoint import save_opt_state
from torch_parity import jax_tree

LOSS_RTOL = 1e-5
PARAM_ATOL = 1e-5
MOVED_RMS = 1e-6


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    return dp.launch(tmp_path_factory.mktemp("dp2"), "parallel", world=2)


@pytest.fixture(scope="module")
def one_rank(tmp_path_factory):
    return dp.launch(tmp_path_factory.mktemp("dp1"), "parallel", world=1)


@pytest.fixture(scope="module")
def one_process():
    """The port's one-process run of every case."""
    return {name: dp.run_case(name) for name in dp.PARALLEL_CASES}


def _moved(opt):
    """Entries whose root-mean-square gradient over the steps (Adam's
    bias-corrected second moment) exceeds MOVED_RMS."""
    return {k: np.sqrt(v / (1 - 0.999 ** dp.STEPS)) > MOVED_RMS
            for k, v in opt["nu"].items()}


def _check_rank(rec, name, losses, names, flat, moved):
    assert list(rec[f"{name}/names"]) == names
    np.testing.assert_allclose(rec[f"{name}/losses"], losses,
                               rtol=LOSS_RTOL, err_msg=name)
    for k, v in flat.items():
        got = rec[f"{name}/param/{k}"]
        m = moved.get(k, np.ones(v.shape, bool))
        np.testing.assert_allclose(got[m], v[m], atol=PARAM_ATOL,
                                   err_msg=f"{name} {k}")


def _jax_run(name, flat):
    """The JAX package's three steps over make_mesh(2): (losses in the
    port's metric order, flat params, moved entries)."""
    model, train, _ = dp.case_configs(name)
    train = {**train, "attn_impl": "einsum"}
    tr = jt.Trainer(JaxConfig(**model), jt.TrainConfig(**train),
                    jax_tree(flat), mesh=jax_make_mesh(2))
    ms = [tr.step(b) for b in dp.batches(name)]
    names = sorted(ms[0])
    losses = np.array([[float(m[k]) for k in names] for m in ms])
    nu = jflatten(tr.state.opt_state[1].inner_state[0].nu)
    moved = {k: np.sqrt(np.asarray(v) / (1 - 0.999 ** dp.STEPS)) > MOVED_RMS
             for k, v in nu.items()}
    return losses, names, jflatten(tr.params), moved


@pytest.mark.parametrize("name", ["diora", "cliora", "cliora_lengths"])
def test_two_ranks_match_one_process_and_jax(name, two_ranks, one_process):
    """DIORA, and CLIORA with VG + contrastive without and with padded
    rows: each rank's losses and parameters equal the port's
    one-process step on the global batch and the JAX dp step."""
    losses, names, flat, opt, _ = one_process[name]
    moved = _moved(opt)
    for rec in two_ranks:
        _check_rank(rec, name, losses, names, flat, moved)
    j_losses, j_names, j_flat, j_moved = _jax_run(name, dp.init_flat(name))
    assert j_names == names
    np.testing.assert_allclose(two_ranks[0][f"{name}/losses"], j_losses,
                               rtol=LOSS_RTOL)
    for k, v in j_flat.items():
        m = j_moved.get(k, np.ones(v.shape, bool)) & moved.get(
            k, np.ones(v.shape, bool))
        np.testing.assert_allclose(two_ranks[0][f"{name}/param/{k}"][m],
                                   np.asarray(v)[m], atol=PARAM_ATOL,
                                   err_msg=k)


@pytest.mark.parametrize("name", ["cliora_einsum", "cliora_dropout",
                                  "cliora_accum"])
def test_two_ranks_match_one_process(name, two_ranks, one_process):
    """The materialized-score route; attention dropout 0.1 (each rank
    draws the global batch's masks and keeps its rows, so the masks are
    the one process's, not one mask repeated on every rank); and two
    microbatches, which slice the global batch as the JAX dp step does
    (microbatch i is global rows [4i, 4i + 4), two from each rank)."""
    losses, names, flat, opt, _ = one_process[name]
    for rec in two_ranks:
        _check_rank(rec, name, losses, names, flat, _moved(opt))


def test_rank_rows_draw_the_global_mask():
    """``RankRows``: each rank's dropout mask is its block of rows of the
    one mask the global batch draws, so the ranks' masks differ rather
    than repeat one mask."""
    import torch

    from cliora_tpu_torch.ops.core import RankRows, dropout_keep

    def gen():
        return torch.Generator().manual_seed(11)

    whole = dropout_keep(gen(), (8, 5, 3), 0.5, "cpu")
    blocks = [dropout_keep(RankRows(gen(), 2, r), (4, 5, 3), 0.5, "cpu")
              for r in range(2)]
    torch.testing.assert_close(torch.cat(blocks), whole, rtol=0, atol=0)
    assert not torch.equal(blocks[0], blocks[1])


@pytest.mark.parametrize("name", ["cliora_zero1", "cliora_lengths_zero1"])
def test_zero1_matches_replicated(name, two_ranks, one_process, tmp_path):
    """ZeRO-1 (Adam on each rank's half of the flat parameters) against
    the replicated optimizer, both on two ranks: parameters at atol 1e-6
    (on the entries with a gradient above rounding noise: the clip norm
    adds its squares in another order), and the ``.opt.pkl`` each writes
    (the full Adam state, gathered from the shards) holds the same count
    and moments."""
    base = name.replace("_zero1", "")
    moved = _moved(one_process[base][3])
    for rec in two_ranks:
        np.testing.assert_allclose(rec[f"{name}/losses"],
                                   rec[f"{base}/losses"], rtol=1e-6)
        keys = [k[len(f"{base}/param/"):] for k in rec
                if k.startswith(f"{base}/param/")]
        for k in keys:
            m = moved.get(k, np.ones(rec[f"{base}/param/{k}"].shape, bool))
            np.testing.assert_allclose(rec[f"{name}/param/{k}"][m],
                                       rec[f"{base}/param/{k}"][m],
                                       atol=1e-6, err_msg=k)
    files = {}
    for tag in (name, base):
        rec = two_ranks[0]
        opt = {"count": int(rec[f"{tag}/opt/count"]),
               "mu": {}, "nu": {}}
        for part in ("mu", "nu"):
            prefix = f"{tag}/opt/{part}/"
            opt[part] = {k[len(prefix):]: rec[k] for k in rec
                         if k.startswith(prefix)}
        files[tag] = str(tmp_path / f"{tag}.opt.pkl")
        save_opt_state(files[tag], opt)
    from cliora_tpu_torch.training.checkpoint import load_opt_state

    z, r = load_opt_state(files[name]), load_opt_state(files[base])
    assert z["count"] == r["count"] == dp.STEPS
    for part in ("mu", "nu"):
        assert z[part].keys() == r[part].keys()
        for k in z[part]:
            np.testing.assert_allclose(z[part][k], r[part][k], atol=1e-6,
                                       rtol=1e-5, err_msg=f"{part} {k}")


def test_zero1_install_state_keeps_the_shards(two_ranks):
    """``install_state`` of a ZeRO-1 trainer's own full state writes each
    rank's slice back unchanged; the slices split the flat parameters in
    two."""
    for rec in two_ranks:
        assert bool(rec["zero1_install_equal"])
    n = sum(v.size for k, v in two_ranks[0].items()
            if k.startswith("cliora_zero1/opt/mu/"))
    assert int(two_ranks[0]["zero1_slice_len"]) == -(-n // 2)


@pytest.mark.parametrize("name", dp.PARALLEL_CASES)
def test_one_rank_equals_no_group(name, one_rank, one_process):
    """A group of one rank (every collective a copy) gives the no-group
    step's bits: losses, parameters and Adam's state."""
    losses, names, flat, opt, _ = one_process[name.replace("_zero1", "")]
    rec = one_rank[0]
    np.testing.assert_array_equal(rec[f"{name}/losses"], losses)
    for k, v in flat.items():
        np.testing.assert_array_equal(rec[f"{name}/param/{k}"], v,
                                      err_msg=k)
    for part in ("mu", "nu"):
        for k, v in opt[part].items():
            np.testing.assert_array_equal(rec[f"{name}/opt/{part}/{k}"], v,
                                          err_msg=f"{part} {k}")


def test_shard_batch_splits_rows():
    """Rank r keeps rows [r*b, (r+1)*b) of every batch-like array
    (``lengths`` too); the shared negative samples stay whole."""
    batch = dp.batches("cliora_lengths")[0]
    mesh = Mesh(size=2, rank=1, backend="gloo")
    got = shard_batch(mesh, batch)
    for k in ("sentences", "obj_feats", "lengths"):
        np.testing.assert_array_equal(got[k], batch[k][4:])
    np.testing.assert_array_equal(got["neg_samples"], batch["neg_samples"])
    whole = shard_batch(None, batch)
    assert all(whole[k] is batch[k] for k in batch)
    assert dp_size(mesh) == 2 and dp_size(None) == 1


def test_shard_batch_indivisible_raises():
    """A batch axis the group does not divide raises; with
    ``on_indivisible='warn'`` it warns and every rank keeps the whole
    batch (cliora_tpu/parallel/mesh.py's contract)."""
    batch = {k: v[:7] if np.ndim(v) >= 2 else v
             for k, v in dp.batches("cliora")[0].items()}
    mesh = Mesh(size=2, rank=0, backend="gloo")
    with pytest.raises(ValueError, match="not divisible"):
        shard_batch(mesh, batch)
    with pytest.warns(UserWarning, match="not divisible"):
        got = shard_batch(mesh, batch, on_indivisible="warn")
    np.testing.assert_array_equal(got["sentences"], batch["sentences"])
