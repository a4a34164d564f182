"""The README's two demonstrations through both packages' train CLIs on
the CPU, at a tenth of their corpora and three epochs: the port must
follow the JAX package's learning run, not only its single steps.

* grammar induction: tools/make_synthetic_ptb.py's corpus, DIORA text
  with the fixed class-structured embeddings (``--data_type ptb --emb
  w2v``), the README's flags at hidden 16;
* phrase grounding: tools/make_synthetic_flickr.py's corpus with its
  HDF5 region features, CLIORA with the VG and contrastive losses on the
  ``chunked`` route (``--obj_feats --vg_loss --use_contr``), f32 and
  attention dropout 0 (the packages draw their dropout masks from
  different generators; the CLI has no flag for it, so both packages'
  config builders are given 0).

Both packages start from their CLI's default ``--seed``, which draws the
same initial model in each (within a few ulp, tests/test_torch_prng.py),
and take the same batches in the same order (tests/test_torch_data.py).
The corpora's word vectors are scaled by ``EMB_SCALE`` (see there).
Eval uses the train buckets (``--eval_buckets``, which leaves the
metrics unchanged), so that the JAX side compiles few shapes.

Tolerances: each epoch's eval metrics within ``METRIC_ATOL`` (a metric
moves only where a near-tie flips a tree or a region argmax), and the
parameters of ``PARAM_EPOCHS`` within ``PARAM_ATOL``, 0.5 % of the
distance Adam can move an entry in an epoch (lr x its 19-27 steps).
"""

import functools
import os
import subprocess
import sys

import numpy as np
import pytest

from cliora_tpu.scripts import common as jax_common
from cliora_tpu.scripts import train as jax_train
from cliora_tpu_torch.scripts import common as port_common
from cliora_tpu_torch.scripts import train as port_train

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EPOCHS = 3
METRIC_ATOL = 0.02
LR = 1e-3
PARAM_ATOL = 1e-4
# the epochs whose parameters are held: every one of the grammar run; the
# first of the grounding run, whose contrastive hinge amplifies rounding
# past it (Adam turns gradients that differ at rounding level into steps
# of ~lr: 1.5e-4 apart after the second epoch, 2.6e-3 after the third)
PARAM_EPOCHS = {"grammar": EPOCHS, "grounding": 1}
# a bias shared by all images cannot move a softmax over images: its
# exact gradient is zero, each package's is rounding, and Adam moves it
# by ~lr either way (chip_smoke.py's DP_ZERO_GRAD_LEAVES)
ZERO_GRAD_LEAVES = ("img_encoder/fc_vis/b",)
# the synthetic word vectors have norm ~8, so from the N(0, 1) init the
# leaf pre-activations sit on tanh's saturation, where XLA's f32 tanh is
# exactly 1 and torch's 1 - 6e-8 (the docstring of
# tests/test_torch_cli.py; ROADMAP, known deltas): the JAX gradient
# through a saturated unit is 0 and the port's ~1e-7, and Adam turns
# that into a step of ~lr.  The corpora's vectors are scaled by this to
# keep the leaves off saturation (from the same seed, both CLIs at their
# unscaled vectors part by 1.3e-4 on 3 entries of the grammar run's
# leaf_fc/w in the first epoch, and by 0.027 in the grounding run's
# third-epoch Recall@1)
EMB_SCALE = 0.1
FLAGS = ["--hidden_dim", "16", "--k_neg", "8",
         "--lr", str(LR), "--max_epoch", str(EPOCHS),
         "--n_length_buckets", "2", "--eval_buckets"]


def _corpus(tmp_path_factory, tool, n_train, n_test):
    """The tool's corpus, its word vectors scaled by ``EMB_SCALE``."""
    root = str(tmp_path_factory.mktemp(tool.split(".")[0]))
    subprocess.run([sys.executable, os.path.join(ROOT, "tools", tool), root,
                    str(n_train), str(n_test)], check=True,
                   capture_output=True, timeout=300)
    path = os.path.join(root, "glove.txt")
    with open(path) as f:
        rows = [line.split() for line in f]
    with open(path, "w") as f:
        for word, *vec in rows:
            f.write(" ".join([word] + [f"{float(x) * EMB_SCALE:.6f}"
                                       for x in vec]) + "\n")
    return root


@pytest.fixture(scope="module")
def grammar_args(tmp_path_factory):
    root = _corpus(tmp_path_factory, "make_synthetic_ptb.py", 300, 50)
    return ["--data_type", "ptb", "--emb", "w2v",
            "--embeddings_path", os.path.join(root, "glove.txt"),
            "--train_path", os.path.join(root, "train.pkl"),
            "--validation_path", os.path.join(root, "valid.pkl"),
            "--batch_size", "32", *FLAGS]


@pytest.fixture(scope="module")
def grounding_args(tmp_path_factory):
    pytest.importorskip("h5py")   # the tool writes HDF5 region features
    root = _corpus(tmp_path_factory, "make_synthetic_flickr.py", 200, 40)
    return ["--data_type", "flickr", "--emb", "w2v",
            "--embeddings_path", os.path.join(root, "glove.txt"),
            "--train_path", os.path.join(root, "flickr_train.json"),
            "--validation_path", os.path.join(root, "flickr_test.json"),
            "--data_path", root + "/", "--obj_feats", "--vg_loss",
            "--use_contr", "--attn_impl", "chunked", "--batch_size", "8",
            *FLAGS]


def _run(module, common, args, monkeypatch):
    """One package's CLI: its per-epoch eval metrics and last epoch's
    parameters, with attention dropout 0."""
    monkeypatch.setattr(common, "ModelConfig", functools.partial(
        common.ModelConfig, attn_dropout=0.0))
    seen = []
    real = module.run_eval

    def run_eval(*a, **kw):
        seen.append(real(*a, **kw))
        return seen[-1]

    monkeypatch.setattr(module, "run_eval", run_eval)
    module.main(args)
    exp = args[args.index("--experiment_path") + 1]
    params = []
    for e in range(EPOCHS):
        with np.load(os.path.join(exp, f"model.epoch_{e}.npz")) as z:
            params.append({k: z[k] for k in z.files})
    return seen, params


@pytest.mark.parametrize("demo", ["grammar", "grounding"])
def test_demo_follows_jax(demo, request, tmp_path, monkeypatch):
    """Both CLIs from their own default ``--seed``: the same initial
    model, then the same learning run."""
    args = request.getfixturevalue(f"{demo}_args")
    runs = {}
    for name, module, common, extra in (
            ("jax", jax_train, jax_common, []),
            ("port", port_train, port_common, ["--device", "cpu"])):
        with monkeypatch.context() as mp:
            runs[name] = _run(module, common, args + extra + [
                "--experiment_path", str(tmp_path / name)], mp)
    (jseen, jparams), (pseen, pparams) = runs["jax"], runs["port"]
    keys = ["corpus_f1", "sent_f1"] + (["grounding_acc"]
                                       if demo == "grounding" else [])
    assert len(jseen) == len(pseen) == EPOCHS
    for want, got in zip(jseen, pseen):
        for k in keys:
            assert abs(got[k] - want[k]) <= METRIC_ATOL, (k, got, want)
    for epoch in range(PARAM_EPOCHS[demo]):
        want, got = jparams[epoch], pparams[epoch]
        assert sorted(got) == sorted(want)
        for k, v in want.items():
            if k not in ZERO_GRAD_LEAVES:
                np.testing.assert_allclose(got[k], v, atol=PARAM_ATOL,
                                           err_msg=f"epoch {epoch} {k}")


def test_grammar_jax_init_is_the_jax_packages(tmp_path):
    """The committed initial model of the README's grammar run, which
    chip_smoke.py holds the port's draw to on the card's host, is the one
    the JAX package's README command builds, bit for bit."""
    import torch_demo_init

    path = str(tmp_path / "init.npz")
    torch_demo_init.write(path)
    with np.load(path) as want, np.load(torch_demo_init.FIXTURE) as got:
        assert sorted(got.files) == sorted(want.files)
        for k in want.files:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
