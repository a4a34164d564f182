"""The port's train and parse CLIs against the JAX package's, on the CPU.

A tiny Flickr-layout corpus whose sentences all have one length, so the
JAX side compiles one train step and one parse; an epoch is one batch of
24 sentences.  Both packages start from one ``--load_model_path
init.npz`` made by the port's init (``port_init``), DIORA at f32:

* the 2-epoch train CLI writes the same ``model.epoch_{0,1}.npz`` within
  the multi-step check's tolerance (atol 1e-3 * lr on the entries Adam
  moved, tests/test_torch_multi_step.py) and logs equal eval F1;
* ``--resume`` crosses both ways: the port resumes the JAX run's epoch-0
  files, the JAX CLI the port's, and each epoch 1 matches the other
  package's uninterrupted one;
* ``parse_diora`` writes equal trees from the JAX run's checkpoint;
* a CLIORA run with ``--lr 0`` logs equal eval metrics (dropout streams
  differ between the packages, so only an unchanged model can be held
  exactly);
* the port's own 3-epoch run and 2 epochs + ``--resume auto`` end with
  equal bits (the port's counterpart of
  tests/test_cli.py::test_exact_resume_reproduces_uninterrupted_run).

The init's embedding table is scaled by ``EMB_SCALE`` so that the leaf
pre-activations stay off tanh's saturation.  With the N(0, 1) table of
``--emb none`` the 1024-d leaf pre-activations reach ~100, where XLA's
f32 ``tanh`` is exactly 1 (from |x| = 8) and torch's is 1 - 6e-8 (to
|x| = 10): the JAX gradient through a saturated leaf unit is 0 and the
port's 1e-7, and Adam turns such a gradient into a step of ~lr.  The
port then drifts from itself by 1e-4 within 3 steps when its init moves
by 1e-7 relative, so no 1e-3 * lr parameter contract can hold there
(ROADMAP, known deltas).

Where an entry's root-mean-square gradient r is near Adam's eps of
1e-8 at a step, Adam's update lr * m / (r + eps) moves by up to
lr * eps * dg / (r + eps) ** 2 for a gradient change dg: at the first
step, one ``embed/mat`` entry had r = 5.6e-9 and the packages' gradients
there parted by 3.8e-11, which is their median distance over that
leaf, and the entry parted by 1.7e-6 at the second step.  So the
parameter checks also leave out the entries where that bound, with dg
the largest that the port's own rounding makes in the leaf at that step
(the ``noise`` run's gradient against the port's), exceeds the
tolerance at an earlier step.

Past its first step Adam can amplify rounding on its own: where an
entry's gradient changes sign between steps its first moment cancels,
and a gradient difference at rounding level becomes a visible step
difference (here 1.2e-6 on 1 of 16,372 checked entries of
``reconstruct/mat`` at the second step).  So the parameter checks also
leave out the entries on which the port's own run moves by more than
the tolerance when its init moves by 1e-7 relative (the ``noise`` run):
what float32 does not determine is no contract between the packages.
At most 1 in 1,000 of the checked entries may be left out in these two
ways together.
"""

import json
import os
import pickle

import numpy as np
import pytest

from cliora_tpu.scripts import parse_diora as jax_parse_diora
from cliora_tpu.scripts import train as jax_train
from cliora_tpu_torch.models.config import ModelConfig
from cliora_tpu_torch.scripts import parse_diora as port_parse_diora
from cliora_tpu_torch.scripts import train as port_train
from cliora_tpu_torch.training import checkpoint as tck
from cliora_tpu_torch.training import trainer as tt
from cliora_tpu_torch.training.trainer import TrainConfig
from torch_parity import port_init

WORDS = ["_PAD", "<unk>", "a", "dog", "cat", "runs", "fast", "the", "big",
         "red", "sits", "jumps"]
LENGTH, N_TRAIN, N_TEST, REGIONS = 5, 24, 8, 3
D, K, LR = 16, 4, 1e-3
SEED = 3
BATCH = 24
EMB_SCALE = 0.01


def _write_split(root, rs, split, n, first_img):
    lines, ids, anno = [], [], {}
    for i in range(n):
        words = [WORDS[rs.randint(2, len(WORDS))] for _ in range(LENGTH)]
        # a random binary tree's spans, root last
        gold = [(j, LENGTH - 1) for j in range(LENGTH - 2, 0, -1)]
        if rs.rand() < 0.5:
            gold = [(0, j) for j in range(1, LENGTH - 1)]
        lines.append([" ".join(words), gold + [(0, LENGTH - 1)]])
        ids.append(f"{first_img + i}\t0")
        anno[f"{first_img + i}_0"] = [
            {"phr0": (1, 3, [0.0, 0.0, 10.0, 10.0]),
             "phr1": (3, 4, [20.0, 0.0, 30.0, 10.0])}, [1, 1]]
    with open(os.path.join(root, f"flickr_{split}.json"), "w") as f:
        f.writelines(json.dumps(x) + "\n" for x in lines)
    with open(os.path.join(root, f"{split}.txt"), "w") as f:
        f.write("\n".join(ids) + "\n")
    if split == "test":
        with open(os.path.join(root, f"gt_anno_{split}.pkl"), "wb") as f:
            pickle.dump(anno, f)
    return [first_img + i for i in range(n)]


def _write_features(root, rs, img_ids, mode):
    import h5py

    n = len(img_ids)
    boxes = np.tile(np.asarray([[0, 0, 10, 10], [20, 0, 30, 10],
                                [40, 0, 50, 10]], np.float32), (n, 1))
    with h5py.File(os.path.join(root, f"{mode}_features_compress.hdf5"),
                   "w") as f:
        f.create_dataset("features", data=rs.randn(n * REGIONS, 2048)
                         .astype(np.float32))
        f.create_dataset("bboxes", data=boxes)
        f.create_dataset("pos_bboxes", data=np.stack(
            [np.arange(n) * REGIONS, np.arange(n) * REGIONS + REGIONS], 1))
    with open(os.path.join(root, f"{mode}_imgid2idx.pkl"), "wb") as f:
        pickle.dump({img: i for i, img in enumerate(img_ids)}, f)
    with open(os.path.join(root, f"{mode}_detection_dict.json"), "w") as f:
        json.dump({str(img): {"classes": ["cat", "dog", "cat"]}
                   for img in img_ids}, f)
    with open(os.path.join(root, "objects_vocab.txt"), "w") as f:
        f.write("cat\ndog\n")


def _init(root, use_obj):
    """``port_init`` weights of the CLI's model as an ``.npz``, the
    embedding table scaled by ``EMB_SCALE``."""
    cfg = ModelConfig(size=D, input_size=1024, use_obj=use_obj)
    tc = TrainConfig(k_neg=K, emb_trainable=not use_obj)
    flat = port_init(cfg, tc, len(WORDS), seed=6)
    flat["embed/embeddings"] = EMB_SCALE * flat["embed/embeddings"]
    path = os.path.join(root, f"init_{'cliora' if use_obj else 'diora'}.npz")
    np.savez(path, **flat)
    return path


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("flickr_cli"))
    rs = np.random.RandomState(0)
    with open(os.path.join(root, "flickr.dic.json"), "w") as f:
        json.dump({w: i for i, w in enumerate(WORDS)}, f)
    for split, n, first in (("train", N_TRAIN, 100), ("test", N_TEST, 500)):
        _write_features(root, rs, _write_split(root, rs, split, n, first),
                        split)
    return root


def _args(corpus, exp, *extra):
    return ["--data_type", "flickr", "--emb", "none",
            "--train_path", os.path.join(corpus, "flickr_train.json"),
            "--validation_path", os.path.join(corpus, "flickr_test.json"),
            "--data_path", corpus + "/", "--experiment_path", exp,
            "--hidden_dim", str(D), "--k_neg", str(K),
            "--batch_size", str(BATCH),
            "--validation_batch_size", "4", "--lr", str(LR),
            "--seed", str(SEED), *extra]


def _recording(module, monkeypatch):
    """Record each epoch's eval metrics of ``module.run_train``."""
    seen = []
    real = module.run_eval

    def run_eval(*a, **kw):
        seen.append(real(*a, **kw))
        return seen[-1]

    monkeypatch.setattr(module, "run_eval", run_eval)
    return seen


@pytest.fixture(scope="module")
def diora_runs(corpus, tmp_path_factory):
    """The 2-epoch DIORA train CLI of each package from one init, and the
    eval metrics each logged."""
    init = _init(corpus, use_obj=False)
    rs = np.random.RandomState(1)
    noisy = {k: (v * (1 + 1e-7 * rs.randn(*v.shape))).astype(np.float32)
             for k, v in _load(init).items()}
    noisy_init = init.replace(".npz", "_noise.npz")
    np.savez(noisy_init, **noisy)
    out = str(tmp_path_factory.mktemp("diora_runs"))
    runs = {}
    with pytest.MonkeyPatch.context() as mp:
        for name, module, start, extra in (
                ("jax", jax_train, init, ()),
                ("port", port_train, init, ("--device", "cpu")),
                ("noise", port_train, noisy_init, ("--device", "cpu"))):
            exp = os.path.join(out, name)
            mp.undo()
            seen = _recording(module, mp)
            module.main(_args(corpus, exp, "--max_epoch", "2",
                              "--load_model_path", start, *extra))
            runs[name] = (exp, seen)
    return runs


def _load(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def _grads(exp, epoch):
    """Each step's gradient up to ``epoch`` (an epoch is one step here)
    from the first moments of a run's ``.opt.pkl`` files, in float64:
    g_t = (mu_t - 0.9 mu_(t-1)) / 0.1."""
    mus = [tck.load_opt_state(os.path.join(
        exp, f"model.epoch_{e}.opt.pkl"))["mu"] for e in range(epoch + 1)]
    return [{k: (v.astype(np.float64) - (0.9 * mus[e - 1][k] if e else 0.0))
             / 0.1 for k, v in mu.items()} for e, mu in enumerate(mus)]


def _eps_amplified(want_path, runs, epoch, atol):
    """Per parameter path, the entries where Adam's eps amplifies the
    port's own rounding past ``atol`` at a step before ``epoch``'s:
    lr * eps * dg / (r + eps) ** 2 > atol, r the root-mean-square
    gradient of the ``.opt.pkl`` beside ``want_path`` at that step and dg
    the noise run's largest gradient change in the leaf there (see the
    module docstring)."""
    eps = 1e-8
    port, noise = (_grads(runs[r][0], epoch) for r in ("port", "noise"))
    out = {}
    for t in range(epoch):
        opt = tck.load_opt_state(os.path.join(
            os.path.dirname(want_path), f"model.epoch_{t}.opt.pkl"))
        for k, v in opt["nu"].items():
            r = np.sqrt(v.astype(np.float64) / (1 - 0.999 ** opt["count"]))
            dg = np.abs(noise[t][k] - port[t][k]).max()
            out[k] = out.get(k, False) | (LR * eps * dg / (r + eps) ** 2
                                          > atol)
    return out


def _assert_close(got_path, want_path, runs, epoch):
    """Parameters within atol 1e-3 * lr on the entries whose
    root-mean-square gradient (the bias-corrected second moment of the
    ``.opt.pkl`` beside ``want_path``) exceeds 1e-6, less those the
    port's rounding moves by more and those Adam's eps amplifies it in
    (see the module docstring)."""
    atol = 1e-3 * LR
    opt = tck.load_opt_state(want_path.replace(".npz", ".opt.pkl"))
    count = opt["count"]
    amplified = _eps_amplified(want_path, runs, epoch, atol)
    got, want = _load(got_path), _load(want_path)
    name = f"model.epoch_{epoch}.npz"
    port = _load(os.path.join(runs["port"][0], name))
    noise = _load(os.path.join(runs["noise"][0], name))
    assert sorted(got) == sorted(want)
    checked = left_out = 0
    for k, v in want.items():
        moved = np.sqrt(opt["nu"][k] / (1 - 0.999 ** count)) > 1e-6
        sensitive = (np.abs(noise[k] - port[k]) > atol) | amplified.get(
            k, False)
        keep = moved & ~sensitive
        checked += int(moved.sum())
        left_out += int((moved & sensitive).sum())
        np.testing.assert_allclose(got[k][keep], v[keep], atol=atol,
                                   err_msg=k)
    assert left_out * 1000 <= checked, (left_out, checked)


def test_train_cli_matches_jax(diora_runs):
    (jexp, jseen), (pexp, pseen) = diora_runs["jax"], diora_runs["port"]
    for epoch in (0, 1):
        _assert_close(os.path.join(pexp, f"model.epoch_{epoch}.npz"),
                      os.path.join(jexp, f"model.epoch_{epoch}.npz"),
                      diora_runs, epoch)
        for name in ("experiment.epoch_{}.json",):
            with open(os.path.join(jexp, name.format(epoch))) as f:
                want = json.load(f)
            with open(os.path.join(pexp, name.format(epoch))) as f:
                got = json.load(f)
            for k in ("step", "epoch", "host_step", "seed", "best_epoch"):
                assert got[k] == want[k], k
    assert len(pseen) == len(jseen) == 2
    for got, want in zip(pseen, jseen):
        for k in ("corpus_f1", "sent_f1"):
            assert got[k] == want[k], k
    assert os.path.exists(os.path.join(pexp, "model.epoch_1.pt"))


def test_resume_crosses_packages(diora_runs, tmp_path):
    """Epoch 1 resumed from the other package's epoch-0 ``.npz``,
    ``.opt.pkl`` and experiment json matches the other package's
    uninterrupted epoch 1, in both directions."""
    jexp, pexp = diora_runs["jax"][0], diora_runs["port"][0]
    for name, module, src, extra in (
            ("port_from_jax", port_train, jexp, ("--device", "cpu")),
            ("jax_from_port", jax_train, pexp, ())):
        exp = str(tmp_path / name)
        module.main(_args(corpus_of(src), exp, "--max_epoch", "2",
                          "--resume", os.path.join(src, "model.epoch_0.npz"),
                          *extra))
        assert not os.path.exists(os.path.join(exp, "model.epoch_0.npz"))
        _assert_close(os.path.join(exp, "model.epoch_1.npz"),
                      os.path.join(src, "model.epoch_1.npz"), diora_runs, 1)


def corpus_of(exp):
    """The corpus directory a run's flags name."""
    with open(os.path.join(exp, "flags.json")) as f:
        return os.path.dirname(json.load(f)["train_path"])


def test_parse_diora_trees_match_jax(diora_runs, tmp_path):
    jexp = diora_runs["jax"][0]
    ckpt = os.path.join(jexp, "model.epoch_1.npz")
    corpus = corpus_of(jexp)
    records = {}
    for name, module, extra in (("jax", jax_parse_diora, ()),
                                ("port", port_parse_diora,
                                 ("--device", "cpu"))):
        exp = str(tmp_path / name)
        module.main(_args(corpus, exp, "--load_model_path", ckpt, *extra))
        with open(os.path.join(exp, "parse.jsonl")) as f:
            records[name] = [json.loads(line) for line in f]
    assert len(records["port"]) == len(records["jax"]) == N_TEST
    for got, want in zip(records["port"], records["jax"]):
        for k in ("example_id", "tree", "tree_index_conll", "sentence",
                  "gold_spans", "pred_spans"):
            assert got[k] == want[k], k
        assert got["parse_impl"] == "plain"


def test_cliora_lr0_eval_matches_jax(corpus, tmp_path, monkeypatch):
    """A CLIORA epoch at ``--lr 0`` (VG + contrastive losses, 2048-d
    regions) from one init: the eval's F1 and grounding recall are
    equal (the port's ``ccra`` is computed after the decode, a known
    delta, ROADMAP)."""
    init = _init(corpus, use_obj=True)
    metrics = {}
    for name, module, extra in (("jax", jax_train, ()),
                                ("port", port_train,
                                 ("--device", "cpu", "--attn_impl",
                                  "chunked"))):
        seen = _recording(module, monkeypatch)
        args = _args(corpus, str(tmp_path / name), "--max_epoch", "1",
                     "--obj_feats", "--use_contr", "--vg_loss",
                     "--load_model_path", init, *extra)
        args[args.index("--lr") + 1] = "0"
        module.main(args)
        (metrics[name],) = seen
    for k in ("corpus_f1", "sent_f1", "grounding_acc"):
        assert metrics["port"][k] == metrics["jax"][k], k
    assert metrics["port"]["grounding_acc"] > 0


def test_port_resume_auto_is_exact(corpus, tmp_path):
    """3 epochs against 2 + ``--resume auto`` in the same experiment
    path: equal bits, and the resumed run trains epoch 2 only."""
    full, res = str(tmp_path / "full"), str(tmp_path / "res")
    port_train.main(_args(corpus, full, "--max_epoch", "3",
                          "--device", "cpu"))
    port_train.main(_args(corpus, res, "--max_epoch", "2",
                          "--device", "cpu"))
    mtime = os.path.getmtime(os.path.join(res, "model.epoch_1.npz"))
    port_train.main(_args(corpus, res, "--max_epoch", "3", "--device", "cpu",
                          "--resume", "auto"))
    assert os.path.getmtime(os.path.join(res, "model.epoch_1.npz")) == mtime
    for suffix in (".npz", ".opt.pkl"):
        a = os.path.join(full, "model.epoch_2" + suffix)
        b = os.path.join(res, "model.epoch_2" + suffix)
        if suffix == ".npz":
            want, got = _load(a), _load(b)
        else:
            want, got = tck.load_opt_state(a), tck.load_opt_state(b)
            assert got["count"] == want["count"]
            want, got = want["mu"] | {"nu/" + k: v for k, v in
                                      want["nu"].items()}, \
                got["mu"] | {"nu/" + k: v for k, v in got["nu"].items()}
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    with open(os.path.join(res, "experiment.epoch_2.json")) as f:
        assert {"step", "epoch", "host_step", "seed"} <= set(json.load(f))


def test_port_max_step_truncates_the_last_group(corpus, tmp_path,
                                                monkeypatch):
    """``--max_step`` with ``--steps_per_call``: the last group of same-shape
    batches is cut so exactly ``max_step`` updates apply (the port's
    counterpart of tests/test_cli.py::test_max_step_with_steps_per_call_cli),
    and ``--profile_steps`` writes a ``torch.profiler`` trace."""
    sizes = []
    real = tt.Trainer.steps

    def spy(self, batch_maps):
        sizes.append(len(batch_maps))
        return real(self, batch_maps)

    monkeypatch.setattr(tt.Trainer, "steps", spy)
    exp = str(tmp_path / "exp")
    port_train.main(_args(corpus, exp, "--device", "cpu", "--max_epoch", "3",
                          "--max_step", "3", "--steps_per_call", "2",
                          "--profile_steps", "2", "--batch_size", "8"))
    assert sizes == [2, 1], sizes
    with open(os.path.join(exp, "experiment.epoch_0.json")) as f:
        assert json.load(f)["step"] == 3
    assert os.path.getsize(os.path.join(exp, "profile", "trace.json")) > 0


def test_port_ckpt_keep_prunes(corpus, tmp_path):
    """``--ckpt_keep 1`` keeps the newest epoch's files and
    ``model.best.*``; the experiment jsons stay."""
    exp = str(tmp_path / "exp")
    port_train.main(_args(corpus, exp, "--device", "cpu", "--max_epoch", "3",
                          "--ckpt_keep", "1"))
    left = sorted(f for f in os.listdir(exp) if f.startswith("model."))
    assert left == ["model.best.npz", "model.best.pt", "model.epoch_2.npz",
                    "model.epoch_2.opt.pkl", "model.epoch_2.pt"], left
    assert os.path.exists(os.path.join(exp, "experiment.epoch_0.json"))
