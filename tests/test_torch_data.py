"""The port's data pipeline and flags against the JAX package's.

The port keeps its own copies of the JAX package's numpy data code
(``data/``, ``utils/flags.py``, the dataset and iterator factories of
``scripts/common.py``).  Here both packages read the same on-disk corpora
with the same options and seeds, and every batch map must be equal key
by key and bit by bit: the same batch order, padding, buckets, negatives
and region features.  No JAX program is compiled.
"""

import json
import os
import pickle
import re
import shlex

import numpy as np
import pytest

from cliora_tpu.scripts import common as jax_common
from cliora_tpu.utils import flags as jax_flags
from cliora_tpu_torch.data import prefetch
from cliora_tpu_torch.scripts import common as port_common
from cliora_tpu_torch.utils import flags as port_flags

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORDS = ["_PAD", "<unk>", "a", "dog", "cat", "runs", "fast", "the", "big",
         "red", "sits", "jumps", "on", "mat"]
FEAT = 32


def _write_split(root, rs, split, n, with_anno):
    lines, ids = [], []
    for i in range(n):
        k = rs.randint(2, 10)
        words = [WORDS[rs.randint(2, len(WORDS))] for _ in range(k)]
        gold = [(j, k - 1) for j in range(k - 2, 0, -1)] + [(0, k - 1)]
        lines.append([" ".join(words), gold])
        ids.append(f"{100 + i}\t0")
    with open(os.path.join(root, f"flickr_{split}.json"), "w") as f:
        f.writelines(json.dumps(x) + "\n" for x in lines)
    with open(os.path.join(root, f"{split}.txt"), "w") as f:
        f.write("\n".join(ids) + "\n")
    if with_anno:
        anno = {f"{100 + i}_0": [{"phr0": (0, 1, [0.0, 0.0, 5.0, 5.0])},
                                 [1, 1]] for i in range(n)}
        with open(os.path.join(root, f"gt_anno_{split}.pkl"), "wb") as f:
            pickle.dump(anno, f)
    with open(os.path.join(root, f"{split}_plain.txt"), "w") as f:
        f.writelines(line[0] + "\n" for line in lines)
    return [100 + i for i in range(n)]


def _write_features(root, rs, img_ids, mode):
    import h5py

    counts = rs.randint(1, 5, len(img_ids))
    ends = np.cumsum(counts)
    with h5py.File(os.path.join(root, f"{mode}_features_compress.hdf5"),
                   "w") as f:
        f.create_dataset("features", data=rs.randn(int(ends[-1]), FEAT)
                         .astype(np.float32))
        f.create_dataset("bboxes", data=rs.rand(int(ends[-1]), 4)
                         .astype(np.float32))
        f.create_dataset("pos_bboxes",
                         data=np.stack([ends - counts, ends], 1))
    with open(os.path.join(root, f"{mode}_imgid2idx.pkl"), "wb") as f:
        pickle.dump({img: i for i, img in enumerate(img_ids)}, f)
    det = {str(img): {"classes": ["cat", "dog", "mat", "cat"][:c]}
           for img, c in zip(img_ids, counts)}
    with open(os.path.join(root, f"{mode}_detection_dict.json"), "w") as f:
        json.dump(det, f)
    with open(os.path.join(root, "objects_vocab.txt"), "w") as f:
        f.write("cat\ndog\nmat\n")


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("corpus"))
    rs = np.random.RandomState(0)
    with open(os.path.join(root, "flickr.dic.json"), "w") as f:
        json.dump({w: i for i, w in enumerate(WORDS)}, f)
    for split, n in (("train", 60), ("test", 13)):
        ids = _write_split(root, rs, split, n, split == "test")
        _write_features(root, rs, ids, split)
    return root


def _corpus_args(corpus, kind):
    if kind == "flickr":
        return ["--data_type", "flickr", "--obj_feats",
                "--train_path", os.path.join(corpus, "flickr_train.json"),
                "--validation_path", os.path.join(corpus, "flickr_test.json"),
                "--data_path", corpus + "/"]
    return ["--data_type", "txt",
            "--train_path", os.path.join(corpus, "train_plain.txt"),
            "--validation_path", os.path.join(corpus, "test_plain.txt")]


MODES = {
    "exact": [],
    "mixed_buckets": ["--length_buckets", "5,9", "--mixed_buckets"],
    "pad_partial": ["--pad_batches", "--include_partial",
                    "--length_buckets", "4,6,9"],
    "blocked": ["--batch_order", "blocked", "--steps_per_call", "3"],
}


def _assert_equal(got, want, where):
    if isinstance(want, dict):
        assert isinstance(got, dict) and sorted(got) == sorted(want), where
        for k in want:
            _assert_equal(got[k], want[k], f"{where}/{k}")
    elif isinstance(want, (list, tuple)):
        assert type(got) is type(want) and len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_equal(g, w, f"{where}[{i}]")
    elif isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray), where
        assert got.dtype == want.dtype and got.shape == want.shape, where
        assert got.tobytes() == want.tobytes(), where
    else:
        assert type(got) is type(want) and got == want, where


def _batches(common, flags, args, seed, validation):
    options = flags.parse_args(flags.argument_parser(), args)
    train, val = common.get_train_and_validation(options)
    it = (common.get_validation_iterator(options, val) if validation
          else common.get_train_iterator(options, train))
    return list(it.get_iterator(random_seed=seed))


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("kind", ["flickr", "txt"])
def test_batches_equal_jax(corpus, tmp_path, kind, mode):
    """Train batches over two epoch seeds, then validation batches: the
    same batch maps, key by key and bit by bit."""
    args = (_corpus_args(corpus, kind) + MODES[mode]
            + ["--batch_size", "4", "--validation_batch_size", "3",
               "--k_neg", "5", "--emb", "none",
               "--experiment_path", str(tmp_path)])
    for seed, validation in ((11, False), (57767, False), (11, True)):
        want = _batches(jax_common, jax_flags, args, seed, validation)
        got = _batches(port_common, port_flags, args + ["--device", "cpu"],
                       seed, validation)
        assert len(want) > 2
        _assert_equal(got, want, f"{kind}/{mode}/{seed}/{validation}")
        if mode in ("mixed_buckets", "pad_partial") and not validation:
            assert all("lengths" in bm for bm in got)


def test_cpu_prefetch_passes_batches_through(corpus, tmp_path):
    """On a CPU device the prefetcher yields the batch maps it is given
    (``Trainer._place_batch`` reads their numpy arrays)."""
    args = (_corpus_args(corpus, "flickr")
            + ["--batch_size", "4", "--k_neg", "5", "--emb", "none",
               "--experiment_path", str(tmp_path), "--device", "cpu"])
    batches = _batches(port_common, port_flags, args, 11, False)
    out = list(prefetch.device_prefetch(iter(batches), "cpu"))
    assert len(out) == len(batches)
    assert all(a is b for a, b in zip(out, batches))


def _script_args(name):
    """The train arguments of ``scripts/<name>``, its variables set."""
    with open(os.path.join(ROOT, "scripts", name)) as f:
        text = f.read()
    body = text[text.index("python -m"):text.index('"$@"')]
    body = re.sub(r'"\$(\w+)', lambda m: f'"/data/{m.group(1).lower()}',
                  body.replace("\\\n", " "))
    return shlex.split(body)[3:]


# the run's identity: drawn at random where the command does not set it
_RUN_IDS = {"uuid", "experiment_name"}


@pytest.mark.parametrize("script", ["train_cliora.sh", "train_diora.sh"])
def test_flags_parse_like_jax(script):
    """The port parses a train script's arguments to the JAX package's
    values on every shared flag; its own flag is ``--device``, and the JAX
    ``--jax_cache_dir`` is gone."""
    args = _script_args(script)
    assert "--train_filter_length" in args
    want = vars(jax_flags.parse_args(jax_flags.argument_parser(), args))
    got = vars(port_flags.parse_args(port_flags.argument_parser(), args))
    assert set(got) - set(want) == {"device"}
    assert set(want) - set(got) == {"jax_cache_dir"}
    for k in set(want) & set(got) - _RUN_IDS:
        assert got[k] == want[k], k
    assert got["device"] == "cuda"


class _ReachedMesh(Exception):
    pass


def _txt_train_args(tmp_path, extra):
    words = [f"w{i}" for i in range(12)]
    rs = np.random.RandomState(0)
    corpus = tmp_path / "train.txt"
    corpus.write_text("".join(
        " ".join(words[i] for i in rs.randint(0, 12, 5)) + "\n"
        for _ in range(8)))
    return ["--device", "cpu", "--data_type", "txt", "--emb", "none",
            "--train_path", str(corpus), "--validation_path", str(corpus),
            "--experiment_path", str(tmp_path / "exp"), "--hidden_dim", "8",
            "--k_neg", "3", "--batch_size", "4", *extra]


@pytest.mark.parametrize("flag, field, value", [
    (["--mp", "2"], "mp", 2), (["--emb", "elmo"], "emb", "elmo")])
def test_formerly_unported_flags_are_accepted(flag, field, value, tmp_path,
                                              monkeypatch):
    """The two flags the port refused until tensor parallelism and the
    ELMo char-CNN were ported now parse (``_UNPORTED`` is empty), and the
    train CLI hands ``--mp 2`` to ``make_mesh`` (tests/test_torch_tp.py
    and tests/test_torch_elmo.py run them)."""
    from cliora_tpu_torch.scripts import train as port_train

    args = flag + ["--experiment_path", str(tmp_path)]
    options = port_flags.parse_args(port_flags.argument_parser(), args)
    assert getattr(options, field) == value
    assert port_flags._UNPORTED == ()
    if field == "mp":
        calls = []

        def make_mesh(n_devices=None, mp=1):
            calls.append((n_devices, mp))
            raise _ReachedMesh

        monkeypatch.setattr(port_train, "make_mesh", make_mesh)
        with pytest.raises(_ReachedMesh):
            port_train.main(_txt_train_args(tmp_path, flag))
        assert calls == [(None, 2)]


def test_mp_without_a_group_names_the_launcher(tmp_path):
    """``--mp 2`` in one process without a process group raises, naming
    ``torch.distributed.run``, as ``--n_devices`` does."""
    from cliora_tpu_torch.scripts import train as port_train

    with pytest.raises(ValueError, match="mp=2.*torch.distributed.run"):
        port_train.main(_txt_train_args(tmp_path, ["--mp", "2"]))


@pytest.mark.parametrize("flag, field, value", [
    (["--n_devices", "2"], "n_devices", 2),
    (["--world_size", "2"], "world_size", 2),
    (["--zero1"], "zero1", True),
    (["--ckpt_backend", "orbax"], "ckpt_backend", "orbax")])
def test_dp_flags_parse(flag, field, value, tmp_path):
    """The data-parallel and checkpoint flags, refused until the
    parallelism slice of the port, now parse as the JAX CLI's do
    (tests/test_torch_multihost.py and tests/test_torch_dist_ckpt.py
    run them)."""
    args = flag + ["--experiment_path", str(tmp_path)]
    got = port_flags.parse_args(port_flags.argument_parser(), args)
    want = jax_flags.parse_args(jax_flags.argument_parser(), args)
    assert getattr(got, field) == getattr(want, field) == value


@pytest.mark.parametrize("flag, field, value", [
    (["--remat"], "remat", True), (["--remat", "auto"], "remat", "auto"),
    (["--arch", "treelstm"], "arch", "treelstm"),
    (["--arch", "word", "--obj_feats"], "arch", "word")])
def test_model_flags_reach_the_config(flag, field, value, tmp_path):
    """The remat and arch flags, refused until the TreeLSTM, remat and
    word slice of the port, now parse and reach ``ModelConfig``."""
    from cliora_tpu_torch.scripts.common import model_config_from_options

    options = port_flags.parse_args(
        port_flags.argument_parser(),
        flag + ["--experiment_path", str(tmp_path)])
    assert getattr(model_config_from_options(options, 100), field) == value


def test_port_route_names(tmp_path):
    """``--parse_impl``/``--attn_impl`` take the port's route names."""
    parser = port_flags.argument_parser()
    ok = port_flags.parse_args(parser, [
        "--parse_impl", "cuda", "--attn_impl", "cuda",
        "--experiment_path", str(tmp_path)])
    assert (ok.parse_impl, ok.attn_impl) == ("cuda", "cuda")
    for flag, jax_name in (("--parse_impl", "pallas"),
                           ("--attn_impl", "pallas")):
        with pytest.raises(SystemExit):
            parser.parse_args([flag, jax_name])
