"""The port's ELMo char-CNN (data/elmo.py) and its cache (data/embeddings.py
``read_elmo``) against the JAX package's (cliora_tpu/data/elmo.py,
cliora_tpu/data/embeddings.py:120-150), on the CPU.

* ``word_to_char_ids``: the same ids;
* ``encode_chars``: random weights at a small width and at the published
  2,048-filter width, within 1e-5 (the convolutions and GEMMs add in
  another order than XLA's);
* ``load_weights``: an HDF5 file and options json in the standard layout,
  written here with ``h5py``, give the same arrays leaf for leaf;
* ``read_elmo``: a missing cache is written under the JAX package's file
  name in its ``.npy`` format (the same header bytes; the vectors within
  1e-5), each package reads the other's cache to the same vectors, and a
  cache that exists is read, not recomputed;
* ``--emb elmo`` through the port's train CLI for one step;
* on a machine with a card only: ``embed_with`` under torch's default
  TF32 flags against the CPU (the convolutions run without TF32).
"""

import json
import os

import numpy as np
import pytest
import torch

from cliora_tpu_torch.data import elmo
from cliora_tpu_torch.data.embeddings import elmo_cache_path, read_elmo

WORDS = ["dog", "a", "extraordinarily", "<S>", "</S>", "zebra-like",
         "naïve", "日本語", "x" * 60, "é" * 30]
SMALL = [[1, 4], [2, 8], [3, 16]]
PUBLISHED = [[1, 32], [2, 32], [3, 64], [4, 128], [5, 256], [6, 512],
             [7, 1024]]


def _weights_files(root, filters, n_highway, char_dim=4, out_dim=12,
                   seed=42):
    """Random ELMo weight and options files in the standard layout
    (tests/test_data.py's writer, any width)."""
    import h5py

    rs = np.random.RandomState(seed)
    options = {"char_cnn": {"activation": "relu",
                            "embedding": {"dim": char_dim},
                            "filters": filters,
                            "max_characters_per_token": 50,
                            "n_characters": 262, "n_highway": n_highway},
               "lstm": {"projection_dim": out_dim}}
    opt_path = os.path.join(root, "options.json")
    with open(opt_path, "w") as f:
        json.dump(options, f)
    w_path = os.path.join(root, "weights.hdf5")
    n = sum(num for _, num in filters)
    with h5py.File(w_path, "w") as f:
        f.create_dataset("char_embed", data=rs.randn(261, char_dim) * 0.1)
        cnn = f.create_group("CNN")
        for i, (width, num) in enumerate(filters):
            cnn.create_dataset(f"W_cnn_{i}",
                               data=rs.randn(1, width, char_dim, num) * 0.1)
            cnn.create_dataset(f"b_cnn_{i}", data=rs.randn(num) * 0.1)
        for k in range(n_highway):
            g = f.create_group(f"CNN_high_{k}")
            for name, shape in (("W_transform", (n, n)), ("b_transform", (n,)),
                                ("W_carry", (n, n)), ("b_carry", (n,))):
                g.create_dataset(name, data=rs.randn(*shape) * 0.1)
        proj = f.create_group("CNN_proj")
        proj.create_dataset("W_proj", data=rs.randn(n, out_dim) * 0.1)
        proj.create_dataset("b_proj", data=rs.randn(out_dim) * 0.1)
    return opt_path, w_path


@pytest.fixture(scope="module")
def small_files(tmp_path_factory):
    return _weights_files(str(tmp_path_factory.mktemp("elmo_small")), SMALL,
                          n_highway=1, out_dim=512)


@pytest.mark.parametrize("word", WORDS)
def test_word_to_char_ids_match_jax(word):
    from cliora_tpu.data.elmo import word_to_char_ids as jax_ids

    assert elmo.word_to_char_ids(word) == jax_ids(word)
    assert len(elmo.word_to_char_ids(word)) == elmo.MAX_WORD_LENGTH


def test_load_weights_match_jax(small_files):
    """Leaf for leaf: the char table with its zero row, each conv's
    (width, E, num) weight and bias, the highways with the carry signs
    flipped, the projection, the activation and the output width."""
    from cliora_tpu.data.elmo import load_weights as jax_load

    got, want = elmo.load_weights(*small_files), jax_load(*small_files)

    def leaves(tree, prefix=""):
        if isinstance(tree, dict):
            return {k: v for key, sub in tree.items()
                    for k, v in leaves(sub, f"{prefix}{key}/").items()}
        if isinstance(tree, list):
            return {k: v for i, sub in enumerate(tree)
                    for k, v in leaves(sub, f"{prefix}{i}/").items()}
        return {prefix[:-1]: tree}

    g, w = leaves(got), leaves(want)
    assert g.keys() == w.keys()
    for k in w:
        if isinstance(w[k], np.ndarray):
            assert g[k].dtype == w[k].dtype, k
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
        else:
            assert g[k] == w[k], k


@pytest.mark.parametrize("filters, n_highway", [(SMALL, 1), (PUBLISHED, 2)],
                         ids=["small", "published_2048"])
def test_encode_chars_matches_jax(filters, n_highway, tmp_path):
    """Random weights: the port's char-CNN on the CPU against the JAX
    package's within 1e-5, at three filters and one highway, and at the
    published 2,048 filters of widths 1-7 with two highways and a 512-d
    projection (16-d chars) on a few words."""
    from cliora_tpu.data.elmo import encode_chars as jax_encode

    char_dim = 4 if filters is SMALL else 16
    weights = elmo.load_weights(*_weights_files(
        str(tmp_path), filters, n_highway, char_dim=char_dim, out_dim=512))
    ids = np.asarray([elmo.word_to_char_ids(w) for w in WORDS], np.int32)
    want = jax_encode(weights, ids)
    got = elmo.encode_chars(elmo.to_device(weights, "cpu"),
                            torch.as_tensor(ids)).numpy()
    assert got.shape == want.shape == (len(WORDS), 512)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def test_read_elmo_writes_the_jax_cache(small_files, tmp_path):
    """A missing cache: the port writes it under the JAX package's name, in
    its ``.npy`` format; each package reads the other's; the 1,024-d
    vectors in word2idx order agree within 1e-5."""
    from cliora_tpu.data.embeddings import read_elmo as jax_read_elmo

    word2idx = {w: i for i, w in enumerate(WORDS)}
    port_dir, jax_dir = str(tmp_path / "port"), str(tmp_path / "jax")
    got, w2i = read_elmo(word2idx, port_dir, *small_files, device="cpu")
    want, jw2i = jax_read_elmo(word2idx, jax_dir, *small_files)
    assert w2i == jw2i == word2idx
    p_path = elmo_cache_path(port_dir, word2idx)
    j_path = elmo_cache_path(jax_dir, word2idx)
    assert os.path.basename(p_path) == os.path.basename(j_path)
    with open(p_path, "rb") as a, open(j_path, "rb") as b:
        pa, pb = a.read(), b.read()
    header = pa.index(b"\n") + 1
    assert len(pa) == len(pb) and pa[:header] == pb[:header]
    assert got.shape == want.shape == (len(WORDS), 1024)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    # each reads the other's cache (no weights given: nothing recomputed)
    np.testing.assert_array_equal(read_elmo(word2idx, jax_dir)[0], want)
    np.testing.assert_array_equal(jax_read_elmo(word2idx, port_dir)[0], got)


def test_read_elmo_needs_local_weight_files(tmp_path):
    """Without a cache, a missing or remote weight file raises (nothing is
    downloaded)."""
    with pytest.raises(ValueError, match="--elmo_options_path"):
        read_elmo({"dog": 0}, str(tmp_path), device="cpu")
    with pytest.raises(ValueError, match="local paths"):
        read_elmo({"dog": 0}, str(tmp_path), "https://example.org/o.json",
                  "w.hdf5", device="cpu")


def test_train_cli_emb_elmo(small_files, tmp_path):
    """``--emb elmo`` through the port's train CLI on the CPU for one step:
    the cache is written, the model's input width is 1,024 and the step's
    losses are finite."""
    from cliora_tpu_torch.scripts import train

    words = [f"w{i}" for i in range(20)]
    rs = np.random.RandomState(0)
    corpus = tmp_path / "train.txt"
    corpus.write_text("".join(
        " ".join(words[i] for i in rs.randint(0, 20, 5)) + "\n"
        for _ in range(8)))
    cache = tmp_path / "cache"
    trainer, records = train.main([
        "--device", "cpu", "--data_type", "txt", "--emb", "elmo",
        "--elmo_options_path", small_files[0],
        "--elmo_weights_path", small_files[1],
        "--elmo_cache_dir", str(cache),
        "--train_path", str(corpus), "--validation_path", str(corpus),
        "--experiment_path", str(tmp_path / "exp"), "--hidden_dim", "8",
        "--k_neg", "3", "--batch_size", "4", "--max_epoch", "1",
        "--max_step", "1"])
    assert [r["step"] for r in records] == [1]
    assert trainer.cfg.input_size == 1024
    assert len(os.listdir(cache)) == 1
    assert all(np.isfinite(v) for v in records[0]["metrics"].values())


def _memory_weights(rs, filters, n_highway, char_dim=16, out_dim=512,
                    scale=0.1):
    """Random char-CNN weights in ``load_weights``' form, built in memory
    (the card's machine has no ``h5py``): row 0 of the char table is the
    zero mask row."""
    def f(*shape):
        return (scale * rs.randn(*shape)).astype(np.float32)

    table = f(263, char_dim)
    table[0] = 0.0
    n = sum(num for _, num in filters)
    return {"table": table,
            "convs": [{"w": f(w, char_dim, num), "b": f(num), "width": w}
                      for w, num in filters],
            "highways": [{"w_t": f(n, n), "b_t": f(n), "w_c": f(n, n),
                          "b_c": f(n)} for _ in range(n_highway)],
            "proj": {"w": f(n, out_dim), "b": f(out_dim)},
            "activation": "relu", "out_dim": out_dim}


@pytest.fixture
def card_with_torch_defaults():
    """A CUDA card, with torch's default TF32 flags for the test (cuDNN
    convolutions may use TF32, matmuls may not) whatever an earlier test
    of the process set; the flags are restored after."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the TF32 flag acts on the card only")
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    before = cudnn.allow_tf32, matmul.allow_tf32
    cudnn.allow_tf32, matmul.allow_tf32 = True, False
    yield torch.device("cuda")
    cudnn.allow_tf32, matmul.allow_tf32 = before


def test_embed_with_on_the_card_keeps_f32(card_with_torch_defaults):
    """``embed_with`` on the card under torch's default flags, at the
    published width: the vectors agree with the CPU's within 1e-4 of the
    largest value (the cache's 1e-5 contract holds only without TF32),
    and the caller's cuDNN setting is left as it was."""
    rs = np.random.RandomState(14)
    weights = _memory_weights(rs, PUBLISHED, 2)
    letters = list("abcdefghijklmnopqrstuvwxyz") + ["é", "ß", "ж", "語"]
    words = sorted({"".join(rs.choice(letters, rs.randint(1, 21)))
                    for _ in range(2000)})
    assert torch.backends.cudnn.allow_tf32
    card = elmo.embed_with(weights, words, device=card_with_torch_defaults)
    assert torch.backends.cudnn.allow_tf32
    cpu = elmo.embed_with(weights, words, device="cpu")
    assert card.shape == cpu.shape == (len(words), 512)
    assert np.abs(card - cpu).max() <= 1e-4 * np.abs(cpu).max()
