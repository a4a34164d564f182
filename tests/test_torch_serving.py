"""The port's serving bundles (cliora_tpu_torch/serving.py, scripts/
export_model.py, scripts/serve.py) against the JAX package's, on the CPU.

One text and one CLIORA model made by the port's init
(``torch_parity.port_init``) go into both packages.  The port's bundles,
in both weight modes, give the trees of the JAX bundles
(cliora_tpu/serving.py) and of the live exact-length parse, and CLIORA's
per-word region argmax too.  The port-only cases of
tests/test_serving.py follow, then two of the port's own: an export
leaves the chart index cache holding real tensors, and a bundle parses
in a process that has loaded none of the port's model modules.

Each bucket's export traces the parse and each load deserializes it
(seconds on the CPU), so the bundles are made and loaded once per module
(``parser``); a test that wraps a program restores it."""

import http.client
import json
import os
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

from cliora_tpu_torch.analysis.trees import bp_to_tree, replace_leaves
from cliora_tpu_torch.chart.indices import INDEX
from cliora_tpu_torch.models.config import ModelConfig
from cliora_tpu_torch.serving import (
    ExportedParser,
    MicroBatcher,
    _pow2_rows,
    export_parser,
    save_bundle,
)
from cliora_tpu_torch.training.checkpoint import params_from_numpy
from cliora_tpu_torch.training.trainer import TrainConfig, Trainer
from torch_parity import jax_tree, port_init

D, E, V, R, F = 16, 24, 50, 3, 8
TEXT_BUCKETS = [4, 6]
OBJ_BUCKET = 4
EMB_SCALE = 0.01   # keeps the leaf tanh off saturation (tests/test_torch_cli.py)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cfg(use_obj):
    extra = dict(use_obj=True, n_regions=R, obj_feat_size=F) if use_obj \
        else {}
    return dict(size=D, input_size=E, **extra)


def _flat(use_obj):
    cfg = ModelConfig(**_cfg(use_obj))
    flat = port_init(cfg, TrainConfig(k_neg=5), V, seed=2 + use_obj)
    flat["embed/embeddings"] = EMB_SCALE * flat["embed/embeddings"]
    return cfg, flat


def _ids(ragged):
    """Ragged numpy id rows -> lists of ints (JSON-ready)."""
    return [list(map(int, s)) for s in ragged]


def _tupleize(t):
    return tuple(_tupleize(x) for x in t) if isinstance(t, list) else t


@pytest.fixture(scope="module")
def bundles(tmp_path_factory):
    """Port bundles, exported on the CPU: text in both weight modes (with a
    vocab), CLIORA in both modes, and a text bundle pinned to 4 rows."""
    root = tmp_path_factory.mktemp("bundles")
    out = {}
    w2i = {"<unk>": 1, "the": 2, "dog": 3, "runs": 4, "fast": 5, "a": 6}
    for use_obj in (False, True):
        cfg, flat = _flat(use_obj)
        params = params_from_numpy(flat, "cpu")
        buckets = [OBJ_BUCKET] if use_obj else TEXT_BUCKETS
        for in_args in (False, True):
            name = f"{'obj' if use_obj else 'text'}_{'args' if in_args else 'baked'}"
            arts = export_parser(cfg, params, buckets, platforms=["cpu"],
                                 params_in_args=in_args)
            out[name + "_bytes"] = {L: len(b) for L, b in arts.items()}
            save_bundle(str(root / name), cfg, arts,
                        word2idx=None if use_obj else w2i,
                        params=params if in_args else None)
            out[name] = str(root / name)
        out["obj" if use_obj else "text"] = (cfg, flat)
    cfg, flat = out["text"]
    save_bundle(str(root / "pinned"), cfg,
                export_parser(cfg, params_from_numpy(flat, "cpu"), [4],
                              platforms=["cpu"], batch=4), batch=4)
    out["pinned"] = str(root / "pinned")
    return out


@pytest.fixture(scope="module")
def parser(bundles):
    """``parser(name)``: the bundle's ExportedParser on the CPU, loaded
    once."""
    loaded = {}

    def get(name):
        if name not in loaded:
            loaded[name] = ExportedParser(bundles[name], device="cpu")
        return loaded[name]

    return get


def _live(cfg, flat, sents, feats=None):
    """Trees (+ region argmax) of the port's live parse, one exact-length
    sentence at a time."""
    tr = Trainer(cfg, TrainConfig(k_neg=5), params_from_numpy(flat, "cpu"),
                 device="cpu")
    trees, attn = [], []
    for i, s in enumerate(sents):
        bm = {"sentences": np.asarray([s])}
        if feats is not None:
            bm["obj_feats"] = feats[i:i + 1]
        res, _ = tr.parse(bm)
        trees.append(bp_to_tree(len(s), res["cky_bp"][0]))
        if feats is not None:
            attn.append(res["atten_score"][0].argmax(-1))
    return trees, attn


def _jax_bundle(tmp_path, use_obj, flat, buckets):
    from cliora_tpu.models.config import ModelConfig as JaxConfig
    from cliora_tpu.serving import ExportedParser as JaxParser
    from cliora_tpu.serving import export_parser as jax_export
    from cliora_tpu.serving import save_bundle as jax_save

    cfg = JaxConfig(**_cfg(use_obj))
    path = str(tmp_path / "jax_bundle")
    jax_save(path, cfg, jax_export(cfg, jax_tree(flat), buckets))
    return JaxParser(path)


def test_text_bundle_matches_jax_and_live(bundles, parser, rng, tmp_path):
    cfg, flat = bundles["text"]
    # ragged lengths straddling both buckets, order-scrambled
    sents = _ids(rng.randint(2, V, n) for n in (3, 6, 5, 2, 4, 6))
    baked = parser("text_baked").parse(sents)
    in_args = parser("text_args").parse(sents)
    jax_trees = _jax_bundle(tmp_path, False, flat, TEXT_BUCKETS).parse(sents)
    live, _ = _live(cfg, flat, sents)
    assert baked == in_args == jax_trees == live


def test_cliora_bundle_matches_jax_and_live(bundles, parser, rng, tmp_path):
    cfg, flat = bundles["obj"]
    sents = _ids(rng.randint(2, V, n) for n in (4, 2, 3))
    feats = rng.randn(3, R, F).astype(np.float32)
    got = {name: parser(name).parse(sents, obj_feats=feats)
           for name in ("obj_baked", "obj_args")}
    jax_trees, jax_attn = _jax_bundle(tmp_path, True, flat,
                                      [OBJ_BUCKET]).parse(sents,
                                                          obj_feats=feats)
    live_trees, live_attn = _live(cfg, flat, sents, feats)
    for trees, attn in got.values():
        assert trees == jax_trees == live_trees
        for a, j, w in zip(attn, jax_attn, live_attn):
            np.testing.assert_array_equal(a, np.asarray(j))
            np.testing.assert_array_equal(a, w)


def test_symbolic_batch_any_size(parser, rng):
    """One program serves B=1 and B=7 alike (symbolic batch dim)."""
    served = parser("text_args")
    calls = served.eager_calls
    one = served.parse([list(rng.randint(2, V, 6))])
    many = served.parse([list(rng.randint(2, V, 6)) for _ in range(7)])
    assert len(one) == 1 and len(many) == 7
    assert served.eager_calls == calls + 2 and served.graph_replays == 0


def test_length_over_largest_bucket_raises(parser, rng):
    with pytest.raises(ValueError, match="exceeds"):
        parser("text_baked").parse([list(rng.randint(2, V, 9))])


def test_unlisted_platform_raises(bundles):
    """A program exported for the CPU only refuses the card, as a JAX
    artifact refuses a platform it was not lowered for."""
    with pytest.raises(ValueError, match="exported for"):
        ExportedParser(bundles["pinned"], device="cuda")


def test_export_model_cli(tmp_path):
    from cliora_tpu_torch.scripts import export_model

    root = str(tmp_path / "corpus")
    os.makedirs(root)
    rs = np.random.RandomState(0)
    words = [f"w{i}" for i in range(30)]
    with open(os.path.join(root, "val.txt"), "w") as f:
        for _ in range(8):
            f.write(" ".join(words[rs.randint(0, 30)]
                             for _ in range(5)) + "\n")

    exp = str(tmp_path / "exp")
    bundle = export_model.main([
        "--device", "cpu", "--data_type", "txt", "--emb", "none",
        "--train_path", os.path.join(root, "val.txt"),
        "--validation_path", os.path.join(root, "val.txt"),
        "--experiment_path", exp,
        "--hidden_dim", "16", "--export_lengths", "3"])
    assert sorted(os.listdir(bundle)) == [
        "manifest.json", "params.npz", "parse_L3.pt2", "vocab.json"]
    served = ExportedParser(bundle, device="cpu")
    assert served.bucket_lengths == [3]
    assert served.meta["params_in_args"] is True
    assert served.meta["format"] == "cliora_tpu_torch.export.v1"
    assert served.meta["torch_version"] == torch.__version__
    # vocab carries only corpus words; any three ids make a sentence
    ids = sorted(served.word2idx.values())[:3]
    assert len(served.parse([ids])) == 1


def test_parse_text_word_leaves(parser):
    served = parser("text_baked")
    trees = served.parse_text(["the dog runs very fast"])  # 'very' -> unk
    leaves = []

    def walk(t):
        if isinstance(t, tuple):
            for x in t:
                walk(x)
        else:
            leaves.append(t)

    walk(trees[0])
    assert leaves == ["the", "dog", "runs", "very", "fast"]
    # same split structure as parsing the ids directly
    ids = [served.word2idx.get(w, 1)
           for w in "the dog runs very fast".split()]
    want = served.parse([ids])[0]
    assert trees[0] == replace_leaves(want, "the dog runs very fast".split())


def test_pinned_batch_bundle(bundles, parser, rng):
    """Pinned-batch bundles record B; the loader chunks and pads requests
    to exactly that size and discards pad outputs."""
    served = parser("pinned")
    assert served.meta["batch"] == 4
    sents = _ids(rng.randint(2, V, n) for n in (3, 4, 2, 4, 3, 2))
    got = served.parse(sents)  # 6 requests -> chunks of 4 + padded 2
    cfg, flat = bundles["text"]
    assert got == _live(cfg, flat, sents)[0]
    assert served.warmup(max_batch=64) == 1


def _spy_rows(served, L, monkeypatch):
    """Record the rows of each call of the bucket-``L`` program (restored
    after the test)."""
    seen = []
    fn = served._fns[L]

    def call(*args):
        seen.append(args[len(served._params)].shape[0])   # the tokens
        return fn(*args)

    monkeypatch.setitem(served._fns, L, call)
    return seen


def test_symbolic_batch_shape_quantization(parser, rng, monkeypatch):
    """Symbolic-batch programs only ever see power-of-two batch sizes (at
    most log2(B) graphs per bucket); pad rows are discarded."""
    assert [_pow2_rows(n) for n in (1, 2, 3, 4, 5, 7, 8, 9)] == \
        [1, 2, 4, 4, 8, 8, 8, 16]
    served = parser("text_args")
    seen = _spy_rows(served, 6, monkeypatch)
    sents = _ids(rng.randint(2, V, n) for n in (5, 6, 6, 5, 6))
    got = served.parse(sents)
    assert seen == [8], seen  # 5 requests -> one padded-to-8 call
    per_one = [served.parse([s])[0] for s in sents]
    assert got == per_one
    assert set(seen[1:]) == {1}  # B=1 quantizes to 1, not 2


def test_warmup_covers_every_quantized_shape(parser, rng, monkeypatch):
    """On the CPU warmup runs each (bucket, pow2 rows) shape once and
    captures nothing; every later call is of a shape it ran."""
    served = parser("text_baked")
    seen = {L: _spy_rows(served, L, monkeypatch) for L in TEXT_BUCKETS}
    calls = served.eager_calls
    assert served.warmup(max_batch=5) == 8  # pow2 cap -> 1, 2, 4, 8
    assert seen == {4: [1, 2, 4, 8], 6: [1, 2, 4, 8]}
    assert served.eager_calls == calls + 8 and served._graphs == {}
    sents = _ids(rng.randint(2, V, 6) for _ in range(5))
    assert len(served.parse(sents)) == 5
    assert seen[6][-1] in seen[6][:4]


def test_warmup_async_joins(parser):
    served = parser("text_args")
    calls = served.eager_calls
    t = served.warmup_async(max_batch=2)
    t.join(timeout=120)
    assert not t.is_alive() and served.eager_calls == calls + 4


def test_parse_max_rows_chunks_oversized_groups(parser, rng, monkeypatch):
    """parse(max_rows=N) never calls a program with more than pow2(N)
    rows, so a warmup(N) covers every call."""
    served = parser("text_baked")
    seen = _spy_rows(served, 6, monkeypatch)
    sents = _ids(rng.randint(2, V, 6) for _ in range(11))
    want = served.parse(sents)           # one 16-row padded call
    assert max(seen) == 16
    seen.clear()
    got = served.parse(sents, max_rows=4)  # chunked: 4+4+4 rows max
    assert max(seen) <= 4 and len(seen) == 3
    assert got == want


def test_params_in_args_bundle_matches_baked(bundles, parser, rng):
    """Weights-as-inputs bundle == baked bundle; its programs are smaller
    (no weight constants) and it carries a params.npz sidecar."""
    assert bundles["text_args_bytes"][6] < bundles["text_baked_bytes"][6]
    assert os.path.exists(os.path.join(bundles["text_args"], "params.npz"))
    served_a = parser("text_args")
    served_b = parser("text_baked")
    assert served_a.meta["params_in_args"] is True
    assert served_b.meta["params_in_args"] is False
    sents = _ids(rng.randint(2, V, n) for n in (3, 6, 5, 2, 4))
    assert served_a.parse(sents) == served_b.parse(sents)


def test_params_in_args_cliora_bundle(parser, rng):
    """CLIORA weights-as-inputs bundle: trees + attention parity with the
    baked one."""
    sents = _ids(rng.randint(2, V, n) for n in (4, 3, 2, 4))
    feats = rng.randn(4, R, F).astype(np.float32)
    trees_b, attn_b = parser("obj_baked").parse(sents, obj_feats=feats)
    trees_a, attn_a = parser("obj_args").parse(sents, obj_feats=feats)
    assert trees_a == trees_b
    for a, b in zip(attn_a, attn_b):
        np.testing.assert_array_equal(a, b)


def test_export_leaves_index_cache_real(bundles, rng):
    """An export traces the chart passes with fake tensors.  The chart
    index cache (chart/indices.py:INDEX) must come out of it holding real
    tensors, so an eager parse after an export equals one before it."""
    cfg, flat = bundles["text"]
    tr = Trainer(cfg, TrainConfig(k_neg=5), params_from_numpy(flat, "cpu"),
                 device="cpu")
    n = 3
    bm = {"sentences": rng.randint(2, V, (2, n)),
          "lengths": np.asarray([3, 2])}
    before, _ = tr.parse(bm)
    for key in [k for k in INDEX._cache if k[1] == n]:
        del INDEX._cache[key]
    export_parser(cfg, tr.params, [n], platforms=["cpu"])
    cached = [t for k, ts in INDEX._cache.items() if k[1] == n for t in ts]
    assert cached and all(type(t) is torch.Tensor for t in cached)
    after, _ = tr.parse(bm)
    np.testing.assert_array_equal(after["cky_bp"], before["cky_bp"])


_LOADER = r"""
import sys
from cliora_tpu_torch.serving import ExportedParser
served = ExportedParser(sys.argv[1], device="cpu")
trees = served.parse([[2, 3, 4], [5, 6, 7, 8]])
loaded = sorted({m for m in sys.modules for sub in
                 ("models", "ops", "training", "chart")
                 if m.startswith("cliora_tpu_torch." + sub)})
print(repr(trees))
print(loaded)
"""


def test_loader_imports_no_model_modules(bundles, parser):
    """The bundle is the model: loading and parsing imports none of the
    port's models, ops, training or chart modules."""
    out = subprocess.run([sys.executable, "-c", _LOADER,
                          bundles["pinned"]], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    trees_line, loaded = out.stdout.strip().splitlines()[-2:]
    assert loaded == "[]", loaded
    want = parser("pinned").parse([[2, 3, 4], [5, 6, 7, 8]])
    assert trees_line == repr(want)


@pytest.fixture(scope="module")
def server(bundles):
    from cliora_tpu_torch.scripts.serve import make_server

    # warm=False: warmup coverage is tested directly above
    srv = make_server(bundles["text_baked"], port=0, max_wait_ms=50.0,
                      warm=False, device="cpu")
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    yield srv
    srv.shutdown()
    srv.batcher.close()


def _post(port, body):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    conn.request("POST", "/parse", json.dumps(body),
                 {"Content-Type": "application/json"})
    resp = conn.getresponse()
    out = resp.status, json.loads(resp.read())
    conn.close()
    return out


def test_http_server_roundtrip(server, parser, rng):
    """scripts/serve.py: POST /parse over a live (threaded) server returns
    the same trees as the in-process loader; a bad request gets a 400."""
    port = server.server_address[1]
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    conn.request("GET", "/healthz")
    health = json.loads(conn.getresponse().read())
    assert health["ok"] and health["meta"]["bucket_lengths"] == TEXT_BUCKETS
    conn.request("POST", "/nope", "{}")
    assert conn.getresponse().status == 404
    conn.close()

    sents = _ids(rng.randint(2, V, n) for n in (4, 6))
    status, got = _post(port, {"sentences": sents})
    want = parser("text_baked").parse(sents)
    assert status == 200 and [_tupleize(t) for t in got["trees"]] == want

    status, got = _post(port, {"texts": ["a dog runs"]})
    assert status == 200
    assert got["trees"] in ([[["a", "dog"], "runs"]],
                            [["a", ["dog", "runs"]]])

    status, got = _post(port, {"sentences": [[2] * 9]})
    assert status == 400 and "exceeds" in got["error"]
    status, got = _post(port, {"sentences": [[2, 3], []]})
    assert status == 400 and "empty sentence" in got["error"]


def test_http_server_concurrent_requests(server, parser, rng):
    """N parallel POSTs through the micro-batched server all come back
    correct (and identical to the in-process loader)."""
    port = server.server_address[1]
    sents = [_ids([rng.randint(2, V, n)]) for n in (3, 4, 5, 6, 4, 3)]
    served = parser("text_baked")
    want = {i: served.parse(s) for i, s in enumerate(sents)}
    got = {}

    def post(i):
        got[i] = _post(port, {"sentences": sents[i]})[1]["trees"]

    threads = [threading.Thread(target=post, args=(i,))
               for i in range(len(sents))]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=60)
    assert len(got) == len(sents)
    for i in got:
        assert [_tupleize(t) for t in got[i]] == want[i], i


def test_microbatcher_coalesces_and_scatters():
    """Concurrent submits within the window run as ONE parser call, and
    each caller gets exactly its own trees back."""
    calls = []

    class FakeParser:
        def parse(self, sentences, max_rows=None):
            calls.append(len(sentences))
            return [("tree", tuple(s)) for s in sentences]

    mb = MicroBatcher(FakeParser(), max_batch=16, max_wait_ms=200.0)
    results = {}

    def worker(i):
        sents = [[i, 0], [i, 1]] if i % 2 else [[i, 9]]
        results[i] = (sents, mb.submit(sents))

    threads = [threading.Thread(target=worker, args=(i,))
               for i in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert len(results) == 6
    for i, (sents, trees) in results.items():
        assert trees == [("tree", tuple(s)) for s in sents], i
    assert sum(calls) == 9
    assert len(calls) <= 3, calls
    mb.close()


def test_microbatcher_error_propagates():
    class Boom:
        def parse(self, sentences, max_rows=None):
            raise ValueError("nope")

    mb = MicroBatcher(Boom(), max_wait_ms=0.0)
    with pytest.raises(ValueError, match="nope"):
        mb.submit([[1, 2]])
    mb.close()


def test_microbatcher_bounds_coalesced_rows():
    """max_batch bounds sentences per device call (the warmup unit), not
    requests: the overflowing request opens the next batch."""
    calls = []

    class FakeParser:
        def parse(self, sentences, max_rows=None):
            calls.append((len(sentences), max_rows))
            return [tuple(s) for s in sentences]

    mb = MicroBatcher(FakeParser(), max_batch=4, max_wait_ms=200.0)
    results = {}

    def worker(i):
        results[i] = mb.submit([[i, j] for j in range(3)])

    threads = [threading.Thread(target=worker, args=(i,))
               for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    for i in range(4):
        assert results[i] == [(i, j) for j in range(3)], i
    assert sum(n for n, _ in calls) == 12
    assert all(n <= 4 for n, _ in calls), calls
    assert all(mr == 4 for _, mr in calls), calls
    mb.close()


def test_microbatcher_isolates_bad_requests():
    """One malformed request in a coalesced batch does not fail its
    batch-mates: the batcher retries per request on batch failure."""
    class Picky:
        def parse(self, sentences, max_rows=None):
            if any(len(s) == 0 for s in sentences):
                raise ValueError("empty sentence")
            return [tuple(s) for s in sentences]

    mb = MicroBatcher(Picky(), max_batch=8, max_wait_ms=200.0)
    results, errors = {}, {}

    def worker(i, sents):
        try:
            results[i] = mb.submit(sents)
        except Exception as e:  # noqa: BLE001
            errors[i] = e

    threads = [
        threading.Thread(target=worker, args=(0, [[1, 2]])),
        threading.Thread(target=worker, args=(1, [[]])),   # bad
        threading.Thread(target=worker, args=(2, [[3, 4], [5]])),
    ]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert results[0] == [(1, 2)]
    assert results[2] == [(3, 4), (5,)]
    assert isinstance(errors[1], ValueError)
    mb.close()
    assert not mb._thread.is_alive()
