"""Checkpoints of a tensor-parallel run of the port (the ``--mp`` cases of
tests/test_orbax.py:65-90 and of the ``.npz`` / ``.opt.pkl`` route).

Two gloo ranks (tests/torch_dp.py, group ``tp_ckpt``) train the text
model under ZeRO-1 at ``(dp, mp) = (1, 2)`` for two steps and write the
chief's ``.npz`` and ``.opt.pkl`` and a DCP directory, all of whole
tensors.  The files load into the JAX package and its third step
matches the port's; the directory restores at (1, 2) into a fresh
trainer whose third step has the uninterrupted one's bits, and at
(1, 1) and (2, 1), replicated and under ZeRO-1, with the saved bits.
The train CLI with ``--mp 2 --zero1`` in two processes resumes exactly
and ends where one process's CLI ends, on the entries that float32
determines there.
"""

import numpy as np
import pytest

import torch_dp as dp
from cliora_tpu_torch.training.checkpoint import flatten
from cliora_tpu_torch.training.dist_ckpt import is_ckpt_dir, restore_state

CLI_ATOL = 1e-5
# the init perturbations of the one-process CLI's noise runs
NOISE_SEEDS = (1, 2)
# the leaves whose gradients pass through the saturated leaf tanh: the
# embedding projection and the leaf projections it feeds
SATURATED_LEAVES = ("embed/mat", "diora/inside_compose/leaf_fc/w",
                    "diora/inside_compose/leaf_fc/b")


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    out = tmp_path_factory.mktemp("tp_ckpt")
    ranks = dp.launch(out, "tp_ckpt", world=2)
    return out, ranks


@pytest.fixture(scope="module")
def restored_by_two_ranks(saved):
    out, _ = saved
    sub = out / "restore"
    sub.mkdir()
    return dp.launch(sub, "tp_restore", world=2)


def _part(rec, tag):
    flat = {k[len(f"{tag}/param/"):]: v for k, v in rec.items()
            if k.startswith(f"{tag}/param/")}
    opt = {"count": int(rec[f"{tag}/opt/count"])}
    for part in ("mu", "nu"):
        prefix = f"{tag}/opt/{part}/"
        opt[part] = {k[len(prefix):]: v for k, v in rec.items()
                     if k.startswith(prefix)}
    return flat, opt


def _assert_equal(a, b):
    (fa, oa), (fb, ob) = a, b
    assert fa.keys() == fb.keys()
    for k in fa:
        np.testing.assert_array_equal(fa[k], fb[k], err_msg=k)
    assert oa["count"] == ob["count"]
    for part in ("mu", "nu"):
        assert oa[part].keys() == ob[part].keys()
        for k in oa[part]:
            np.testing.assert_array_equal(oa[part][k], ob[part][k],
                                          err_msg=f"{part} {k}")


def test_files_hold_whole_tensors_equal_to_one_process(saved):
    """The chief's ``.npz`` and ``.opt.pkl`` at mp = 2 hold the whole
    tensors, equal to one process's after the same two steps (atol
    1e-5), and the ranks saw one state."""
    from cliora_tpu_torch.training.checkpoint import load_opt_state

    out, ranks = saved
    tr = dp.trainer("diora")
    for b in dp.batches("diora")[:2]:
        tr.step(b)
    want, want_opt = flatten(tr.params), tr.opt_state()
    with np.load(out / "tp.npz") as z:
        got = {k: z[k] for k in z.files}
    assert got.keys() == want.keys()
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, atol=1e-5, err_msg=k)
    opt = load_opt_state(str(out / "tp.opt.pkl"))
    assert opt["count"] == want_opt["count"] == 2
    for part in ("mu", "nu"):
        for k, v in want_opt[part].items():
            np.testing.assert_allclose(opt[part][k], v, atol=1e-6,
                                       rtol=1e-4, err_msg=f"{part} {k}")
    _assert_equal(_part(ranks[0], "saved"), _part(ranks[1], "saved"))


def test_files_load_in_jax(saved):
    """The ``.npz`` and ``.opt.pkl`` written at mp = 2 install into a JAX
    trainer, whose third step matches the port's uninterrupted third step
    at (1, 2): loss rtol 1e-5, parameters atol 1e-5."""
    from cliora_tpu.models.config import ModelConfig as JaxConfig
    from cliora_tpu.training import checkpoint as jck
    from cliora_tpu.training import trainer as jt
    from torch_parity import jax_tree

    out, ranks = saved
    model, train, _ = dp.case_configs("diora")
    jtr = jt.Trainer(JaxConfig(**model),
                     jt.TrainConfig(**{**train, "attn_impl": "einsum"}),
                     jax_tree(dp.init_flat("diora")))
    params, missing = jck.load_params(str(out / "tp.npz"), jtr.params)
    assert missing == []
    jtr.install_state(params, jck.load_opt_state(str(out / "tp.opt.pkl"),
                                                 jtr.state.opt_state))
    jtr.set_step(2)
    m = jtr.step(dp.batches("diora")[2])
    flat, _ = _part(ranks[0], "uninterrupted")
    np.testing.assert_allclose(float(m["total_loss"]),
                               ranks[0]["uninterrupted/losses"][0, 0],
                               rtol=1e-5)
    for k, v in jck.flatten(jtr.params).items():
        np.testing.assert_allclose(flat[k], np.asarray(v), atol=1e-5,
                                   err_msg=k)


def test_resume_at_the_same_split_is_bit_identical(saved):
    """A fresh (1, 2) trainer restored from the DCP directory takes the
    third step with the uninterrupted trainer's bits."""
    out, ranks = saved
    assert is_ckpt_dir(str(out / "tp.dcp"))
    for rec in ranks:
        np.testing.assert_array_equal(rec["resumed/losses"],
                                      rec["uninterrupted/losses"])
        _assert_equal(_part(rec, "resumed"), _part(rec, "uninterrupted"))


@pytest.mark.parametrize("name", ["diora", "diora_zero1"])
def test_restore_at_one_process(name, saved):
    """The (1, 2) directory restored at (1, 1): the saved whole state."""
    out, ranks = saved
    tr = dp.trainer(name)
    restore_state(str(out / "tp.dcp"), tr)
    _assert_equal((flatten(tr.params), tr.opt_state()),
                  _part(ranks[0], "saved"))
    assert tr._host_step == 2


@pytest.mark.parametrize("zero1", [False, True])
def test_restore_at_two_dp_ranks(zero1, saved, restored_by_two_ranks):
    """The (1, 2) directory restored at (2, 1), replicated and under
    ZeRO-1: every rank holds the saved state."""
    _, ranks = saved
    for rec in restored_by_two_ranks:
        _assert_equal(_part(rec, f"zero1_{zero1}"), _part(ranks[0], "saved"))


def _cli_init(corpus, path):
    """The one-process train CLI's initial model (its ``--seed``) as an
    ``.npz``."""
    from cliora_tpu_torch.scripts import common
    from cliora_tpu_torch.training.trainer import Trainer
    from cliora_tpu_torch.utils.flags import argument_parser, parse_args

    options = parse_args(argument_parser(), dp.cli_flags(corpus))
    emb = common.get_train_and_validation(options)[0]["embeddings"]
    np.savez(path, **flatten(Trainer.build(
        common.model_config_from_options(options, emb),
        common.train_config_from_options(options), emb, seed=options.seed,
        device="cpu").params))


def test_cli_mp2_resume_and_one_process(tmp_path):
    """The train CLI with ``--mp 2 --zero1`` in two processes (``--device
    cpu``, gloo): two epochs with the chief's files, then both ranks
    resume from epoch 0 and train epoch 1 to the uninterrupted run's
    bits; its epoch-1 parameters equal one process's CLI run at atol
    ``CLI_ATOL``.

    The ``--emb none`` init (an N(0, 1) 1024-d table) saturates the leaf
    tanh (ROADMAP, known deltas), and Adam turns the rounding-level
    gradients there, whose order mp changes, into visible steps: from an
    init moved by 1e-7 relative, one process's own run moves entries of
    ``embed/mat`` by up to 1.1e-4.  So the comparison leaves out the
    entries that such a run (``NOISE_SEEDS``) moves by more than
    ``CLI_ATOL``: at most 1 in 1,000, and only in ``SATURATED_LEAVES``."""
    from cliora_tpu_torch.scripts import train

    corpus = str(tmp_path / "corpus")
    dp.write_corpus(corpus)
    recs = dp.launch(tmp_path, "tp_cli", world=2)
    exp1, exp2 = tmp_path / "exp1", tmp_path / "exp2"
    for rec in recs:
        np.testing.assert_array_equal(rec["epochs"], [0, 1, 1])
        assert rec["f1"][1] == rec["f1"][2]
    a = np.load(exp1 / "model.epoch_1.npz")
    b = np.load(exp2 / "model.epoch_1.npz")
    assert sorted(a.files) == sorted(b.files)
    for k in a.files:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    one = tmp_path / "one"
    train.main(dp.cli_flags(corpus, ["--experiment_path", str(one),
                                     "--max_epoch", "2"]))
    c = np.load(one / "model.epoch_1.npz")
    assert sorted(a.files) == sorted(c.files)
    init = str(tmp_path / "init.npz")
    _cli_init(corpus, init)
    with np.load(init) as z:
        start = {k: z[k] for k in z.files}
    sensitive = {k: np.zeros(c[k].shape, bool) for k in c.files}
    for seed in NOISE_SEEDS:
        rs = np.random.RandomState(seed)
        noisy = str(tmp_path / f"noise{seed}.npz")
        np.savez(noisy, **{k: (v * (1 + 1e-7 * rs.randn(*v.shape)))
                           .astype(np.float32) for k, v in start.items()})
        exp = tmp_path / f"noise{seed}"
        train.main(dp.cli_flags(corpus, [
            "--experiment_path", str(exp), "--max_epoch", "2",
            "--load_model_path", noisy]))
        n = np.load(exp / "model.epoch_1.npz")
        for k in c.files:
            sensitive[k] |= np.abs(n[k] - c[k]) > CLI_ATOL
    checked = left_out = 0
    for k in c.files:
        keep = ~sensitive[k]
        checked += c[k].size
        left_out += int(sensitive[k].sum())
        np.testing.assert_allclose(a[k][keep], c[k][keep], atol=CLI_ATOL,
                                   err_msg=k)
    assert left_out * 1000 <= checked, (left_out, checked)
    stray = [k for k in c.files
             if sensitive[k].any() and k not in SATURATED_LEAVES]
    assert not stray, stray
