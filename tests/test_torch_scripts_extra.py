"""The port's remaining inference scripts against the JAX package's, on
the CPU: ``right_branch`` (no model), ``convert_conll_to_jsonl`` (pure
Python), ``phrase_embed_simple`` in its three modes and ``phrase_embed``.

Both packages read the same corpus and start from one ``--load_model_path``
``.npz`` made by the port's init (``torch_parity.port_init``; the
embedding table scaled by 0.01 as in tests/test_torch_cli.py, so the
leaf tanh stays off saturation).  Files and printed neighbours must be
equal; span vectors agree within the chart tolerance of
tests/test_torch_chart_pass.py."""

import json
import pickle

import numpy as np
import pytest

from cliora_tpu.scripts import convert_conll_to_jsonl as jax_convert
from cliora_tpu.scripts import phrase_embed as jax_phrase_embed
from cliora_tpu.scripts import phrase_embed_simple as jax_simple
from cliora_tpu.scripts import right_branch as jax_right_branch
from cliora_tpu_torch.models.config import ModelConfig
from cliora_tpu_torch.scripts import convert_conll_to_jsonl as port_convert
from cliora_tpu_torch.scripts import phrase_embed as port_phrase_embed
from cliora_tpu_torch.scripts import phrase_embed_simple as port_simple
from cliora_tpu_torch.scripts import right_branch as port_right_branch
from cliora_tpu_torch.scripts.common import get_validation_dataset
from cliora_tpu_torch.training.trainer import TrainConfig
from cliora_tpu_torch.utils.flags import argument_parser, parse_args
from torch_parity import port_init

D = 16
CHART_ATOL = 2e-5        # tests/test_torch_chart_pass.py:45
EMB_SCALE = 0.01
WORDS = ["the", "a", "big", "red", "small", "dog", "cat", "bird", "runs",
         "sits", "fast", "down", "today", "here"]

TREES = [
    [[["a", "dog"], ["runs", "fast"]], "today"],
    [["the", ["big", "cat"]], ["sits", "down"]],
    [[["a", "cat"], ["sits", "down"]], "today"],
    [["the", ["red", "dog"]], ["runs", "up"]],
    [["a", ["small", "bird"]], [["sits", "here"], "today"]],
    [[["the", "dog"], "runs"], "here"],
]


def _bio(rs, n):
    """``n`` BIO sentences of 5-7 words, each with a 2-3 word NP at its
    start and, in most, a 2-word NP later."""
    blocks = []
    for _ in range(n):
        words = [WORDS[rs.randint(len(WORDS))] for _ in range(rs.randint(5, 8))]
        tags = ["O"] * len(words)
        size = rs.randint(2, 4)
        tags[:size] = ["B-NP"] + ["I-NP"] * (size - 1)
        if len(words) - size >= 3 and rs.rand() < 0.8:
            at = rs.randint(size + 1, len(words) - 1)
            tags[at:at + 2] = ["B-NP", "I-NP"]
        blocks.append("\n".join(f"{w} X {t}" for w, t in zip(words, tags)))
    return "\n\n".join(blocks) + "\n"


def _args(data_type, path, *extra):
    return ["--data_type", data_type, "--emb", "none",
            "--validation_path", path, "--hidden_dim", str(D),
            "--k_neg", "2", "--validation_batch_size", "4", "--seed", "3",
            *extra]


def _init(tmp, data_type, path):
    """The port's init of the scripts' model at the corpus's vocab size,
    as an ``.npz``."""
    options = parse_args(argument_parser(), _args(data_type, path))
    vocab = len(get_validation_dataset(options)["word2idx"])
    flat = port_init(ModelConfig(size=D, input_size=1024),
                     TrainConfig(k_neg=2, emb_trainable=True), vocab, seed=5)
    flat["embed/embeddings"] = EMB_SCALE * flat["embed/embeddings"]
    out = str(tmp / f"init_{data_type}.npz")
    np.savez(out, **flat)
    return out


def _both(main_jax, main_port, args, tmp, capsys):
    """Run the JAX and the port script on ``args`` with experiment dirs
    ``tmp/jax`` and ``tmp/port``; returns each one's (result, stdout)."""
    out = {}
    for name, main, extra in (("jax", main_jax, []),
                              ("port", main_port, ["--device", "cpu"])):
        exp = ["--experiment_path", str(tmp / name)]
        res = main(args + exp + extra)
        out[name] = (res, capsys.readouterr().out)
    return out


@pytest.fixture(scope="module")
def jsonl_corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("jsonl")
    path = root / "val.jsonl"
    with open(path, "w") as f:
        for i, tree in enumerate(TREES):
            f.write(json.dumps({"example_id": f"ex{i}", "tree": tree})
                    + "\n")
    return str(path), _init(root, "jsonl", str(path))


@pytest.mark.parametrize("mode", ["all-spans", "latent", "given"])
def test_phrase_embed_simple_matches_jax(jsonl_corpus, tmp_path, capsys,
                                         mode):
    path, init = jsonl_corpus
    args = _args("jsonl", path, "--parse_mode", mode,
                 "--load_model_path", init)
    _both(jax_simple.main, port_simple.main, args, tmp_path, capsys)
    got = {}
    for name in ("jax", "port"):
        with open(tmp_path / name / "vectors.csv") as f:
            rows = f.read()
        got[name] = (rows, np.loadtxt(tmp_path / name / "vectors.npy",
                                      ndmin=2))
    assert got["port"][0] == got["jax"][0]
    assert got["port"][1].shape == got["jax"][1].shape
    assert got["port"][1].shape[1] == 2 * D
    np.testing.assert_allclose(got["port"][1], got["jax"][1], rtol=0,
                               atol=CHART_ATOL)


def test_phrase_embed_neighbours_match_jax(tmp_path, capsys):
    rs = np.random.RandomState(4)
    bio = tmp_path / "train.txt"
    bio.write_text(_bio(rs, 12))
    port_convert.main(["--path", str(bio), "--name", "t"])
    conll = tmp_path / "conll_val.jsonl"
    conll.write_text(capsys.readouterr().out)
    init = _init(tmp_path, "conll", str(conll))
    args = _args("conll", str(conll), "--k_candidates", "8", "--k_top", "3",
                 "--load_model_path", init)
    out = _both(jax_phrase_embed.main, port_phrase_embed.main, args,
                tmp_path, capsys)
    (jax_vecs, jax_out), (port_vecs, port_out) = out["jax"], out["port"]
    printed = [line for line in port_out.splitlines()
               if line.startswith(("[query]", "rank="))]
    assert printed == [line for line in jax_out.splitlines()
                       if line.startswith(("[query]", "rank="))]
    assert sum(line.startswith("rank=") for line in printed) >= 20
    np.testing.assert_allclose(port_vecs, jax_vecs, rtol=0, atol=CHART_ATOL)
    np.testing.assert_allclose(np.linalg.norm(port_vecs, axis=1), 1.0,
                               rtol=1e-5)


def test_inner_product_search_ties_take_first_index():
    """Equal scores rank the lower index first, as a stable sort does."""
    vecs = np.asarray([[1, 0], [0, 1], [1, 0], [0.6, 0.8], [1, 0]],
                      np.float32)
    scores, idx = port_phrase_embed.inner_product_search(vecs, 4, "cpu")
    np.testing.assert_array_equal(idx[0], [0, 2, 4, 3])
    np.testing.assert_array_equal(idx[2], [0, 2, 4, 3])
    want = jax_phrase_embed.InnerProductIndex(2)
    want.add(vecs)
    w_scores, _ = want.search(vecs, 4)
    np.testing.assert_allclose(scores, w_scores, rtol=0, atol=1e-6)


def test_convert_conll_matches_jax(tmp_path, capsys):
    rs = np.random.RandomState(1)
    bio = tmp_path / "train.txt"
    bio.write_text(_bio(rs, 6))
    outs = []
    for module in (jax_convert, port_convert):
        module.main(["--path", str(bio), "--name", "t"])
        outs.append(capsys.readouterr().out)
    assert outs[0] == outs[1]
    examples = [json.loads(line) for line in outs[1].strip().split("\n")]
    assert len(examples) == 6 and all(ex["entities"] for ex in examples)


def test_convert_conll_malformed_i_tag_matches_jax(tmp_path, capsys):
    """I without a preceding entity is coerced to B with a warning."""
    bio = tmp_path / "bad.txt"
    bio.write_text("dog NN I-NP\nruns VBZ O\nfast RB I-ADV\n")
    outs = []
    for module in (jax_convert, port_convert):
        module.main(["--path", str(bio)])
        outs.append(capsys.readouterr().out)
    assert outs[0] == outs[1]
    ex = json.loads(outs[1].strip())
    assert ex["entities"] == [["NP", 0, 1], ["ADV", 2, 1]]
    assert sum("Converting I to B" in w for w in ex["warnings"]) == 2


def test_right_branch_matches_jax(tmp_path, capsys):
    """The right-branching baseline's corpus and sentence F1 over a PTB
    pickle of gold spans: right-branching on some rows, left-branching
    spans on others."""
    rs = np.random.RandomState(2)
    rows, w2i = [], {"<unk>": 0}
    for w in WORDS:
        w2i[w] = len(w2i)
    for _ in range(10):
        n = rs.randint(3, 8)
        words = [WORDS[rs.randint(len(WORDS))] for _ in range(n)]
        if rs.rand() < 0.5:
            gold = [(j, n - 1) for j in range(n - 2, 0, -1)]
        else:   # left-branching, one span short of a full tree
            gold = [(0, j) for j in range(2, n - 1)]
        rows.append([" ".join(words), None, None, None, None,
                     gold + [(0, n - 1)]])
    path = tmp_path / "ptb.pkl"
    with open(path, "wb") as f:
        pickle.dump({"other_data": rows, "word2idx": w2i}, f)
    args = ["--data_type", "ptb", "--emb", "none",
            "--validation_path", str(path),
            "--validation_batch_size", "4", "--seed", "3"]
    out = _both(jax_right_branch.main, port_right_branch.main, args,
                tmp_path, capsys)
    assert out["port"] == out["jax"]
    sent_f1 = float(out["port"][1].split("sent_f1:")[1])
    assert 0.0 < out["port"][0] < 1.0 and 0.0 < sent_f1 < 1.0
