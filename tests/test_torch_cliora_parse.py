"""The CLIORA parse and its eval: the port's ``Trainer.parse`` against the
JAX package's ``Trainer.parse`` from the same weights -- backpointers,
the word x region and span x region scores, the charts and the eval
losses -- for CLIORA with and without ``lengths`` and the outside pass,
for DIORA under ``compute_loss``/``with_chart``, and bf16 by agreement;
then ``run_eval`` of both packages over one small iterator.

The JAX side compiles five parse signatures: the four cases below and the
eval's uniform batch (its ragged batch is the ``lengths`` case's call)."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from cliora_tpu.analysis.eval import run_eval as jax_run_eval
from cliora_tpu.analysis.grounding import GroundingMeter as JaxGroundingMeter
from cliora_tpu.analysis.grounding import ground_phrases as jax_ground_phrases
from cliora_tpu.analysis.trees import decode_batch as jax_decode_batch
from cliora_tpu.analysis.trees import tree_to_spans
from cliora_tpu.models.config import ModelConfig as JaxConfig
from cliora_tpu.models.params import init_params as jax_init_params
from cliora_tpu.training import trainer as jt
from cliora_tpu.training.checkpoint import flatten
from cliora_tpu_torch.analysis.eval import run_eval
from cliora_tpu_torch.models.config import ModelConfig
from cliora_tpu_torch.training import trainer as tt
from cliora_tpu_torch.training.checkpoint import params_from_numpy

D, E, V, R, F, K = 16, 24, 50, 4, 32, 5
B, L = 4, 5
LENGTHS = np.array([5, 2, 4, 3], np.int32)
SCORE_ATOL = 1e-5
CHART_ATOL = 2e-5        # tests/test_torch_chart_pass.py:45
LOSS_RTOL = 1e-4         # test_eval_step_matches_jax
BF16_BP_AGREE = 0.95     # test_parse_bf16_tracks_jax
BF16_COS = 0.99


def _configs(use_obj, compute_dtype="float32", **model_kw):
    model = dict(size=D, input_size=E, compute_dtype=compute_dtype,
                 **model_kw)
    train = dict(lr=1e-3, k_neg=K, emb_trainable=True)
    if use_obj:
        model.update(use_obj=True, n_regions=R, obj_feat_size=F,
                     attn_dropout=0.0)
        train.update(vg_loss=True, use_contr=True)
    return (JaxConfig(**model), jt.TrainConfig(**train),
            ModelConfig(**model), tt.TrainConfig(**train))


def _params(jcfg, seed=4):
    """JAX init, with the zero-init image encoder perturbed off the tied
    state: with all-zero regions every region score ties."""
    params = jax_init_params(jax.random.PRNGKey(seed), jcfg, V)
    if "img_encoder" in params:
        key = jax.random.PRNGKey(9)
        params["img_encoder"] = jax.tree.map(
            lambda x: 0.01 * jax.random.normal(key, x.shape),
            params["img_encoder"])
    return params


def _pair(use_obj, compute_dtype="float32"):
    jcfg, jtc, cfg, tc = _configs(use_obj)
    params = _params(jcfg)
    if compute_dtype != "float32":
        cfg = dataclasses.replace(cfg, compute_dtype=compute_dtype)
    return (jt.Trainer(jcfg, jtc, params),
            tt.Trainer(cfg, tc, params_from_numpy(flatten(params), "cpu"),
                       device="cpu"))


@pytest.fixture(scope="module")
def cliora():
    return _pair(True)


def _batch(seed, lengths=False, use_obj=True):
    rs = np.random.RandomState(seed)
    batch = {"sentences": rs.randint(2, V, (B, L)),
             "neg_samples": rs.choice(V, K, replace=False)}
    if use_obj:
        batch["obj_feats"] = rs.randn(B, R, F).astype(np.float32)
    if lengths:
        batch["lengths"] = LENGTHS
    return batch


def _assert_parse_matches(got, want, got_m, want_m):
    assert got["parse_impl"] == "plain" and want["parse_impl"] == "xla"
    assert set(got) == set(want)
    np.testing.assert_array_equal(got["cky_bp"], want["cky_bp"])
    for k in ("atten_score", "span_scores"):
        if k in want:
            assert got[k].shape == want[k].shape, k
            np.testing.assert_allclose(got[k], want[k], atol=SCORE_ATOL,
                                       err_msg=k)
    for k in ("inside_h", "outside_h"):
        if k in want:
            np.testing.assert_allclose(got[k], np.asarray(want[k]),
                                       atol=CHART_ATOL, err_msg=k)
    assert set(got_m) == set(want_m)
    for k in want_m:
        assert isinstance(got_m[k], float)
        np.testing.assert_allclose(got_m[k], want_m[k], rtol=LOSS_RTOL,
                                   err_msg=k)


@pytest.mark.parametrize("lengths,kwargs,keys", [
    (False, dict(compute_loss=True, with_chart=True),
     {"atten_score", "span_scores", "inside_h", "outside_h"}),
    # the eval's call (run_eval below sends this batch)
    (True, dict(compute_loss=False), {"atten_score", "span_scores"}),
    (False, dict(outside=False, with_chart=True),
     {"atten_score", "span_scores", "inside_h"}),
], ids=["loss-chart", "lengths", "no-outside"])
def test_cliora_parse_matches_jax(cliora, lengths, kwargs, keys):
    jtr, ttr = cliora
    batch = _batch(1, lengths=lengths)
    want, want_m = jtr.parse(batch, **kwargs)
    got, got_m = ttr.parse(batch, **kwargs)
    assert set(got) == keys | {"cky_bp", "parse_impl"}
    _assert_parse_matches(got, want, got_m, want_m)
    if kwargs.get("compute_loss"):
        assert set(got_m) == {"reconstruction_softmax_loss", "vg_loss",
                              "contrastive_loss", "total_loss"}
    if lengths:
        lens = batch["lengths"]
        dec = [t for t, _ in jax_decode_batch(got["cky_bp"], L, lens)]
        assert all(len(tree_to_spans(t)) == m - 1 for t, m in zip(dec, lens))


def test_diora_parse_with_loss_and_chart_matches_jax():
    """A DIORA model now parses under ``with_chart`` too, and
    ``compute_loss`` gives it the reconstruction loss alone."""
    jtr, ttr = _pair(False)
    batch = _batch(2, use_obj=False)
    kwargs = dict(compute_loss=True, with_chart=True)
    want, want_m = jtr.parse(batch, **kwargs)
    got, got_m = ttr.parse(batch, **kwargs)
    assert set(got) == {"cky_bp", "inside_h", "outside_h", "parse_impl"}
    assert set(got_m) == {"reconstruction_softmax_loss", "total_loss"}
    _assert_parse_matches(got, want, got_m, want_m)


@pytest.mark.parametrize("use_obj,kwargs,route,arch", [
    (True, {}, "plain", "mlp"),
    (False, {}, "cuda", "mlp"),
    (False, dict(compute_loss=True), "plain", "mlp"),
    (False, dict(with_chart=True), "plain", "mlp"),
    (False, dict(outside=True), "plain", "mlp"),
    (False, {}, "plain", "treelstm"),
    (True, {}, "plain", "word"),
], ids=["cliora", "diora", "diora-loss", "diora-chart", "diora-outside",
        "diora-treelstm", "word"])
def test_route_keeps_the_jax_gating(monkeypatch, use_obj, kwargs, route,
                                    arch):
    """On a CUDA trainer the kernel K1 decodes only a text-only mlp
    request for backpointers alone; a CLIORA model, a TreeLSTM or word
    model, losses, charts and the outside pass take the plain route
    (cliora_tpu/training/trainer.py:745-757).  The trainer's device is
    only claimed here: the route is decided before anything runs."""
    _, _, cfg, tc = _configs(use_obj, arch=arch)
    ttr = tt.Trainer.build(cfg, tc, V, device="cpu")
    monkeypatch.setattr(ttr, "device", torch.device("cuda"))
    assert ttr._route("cuda", _batch(0, use_obj=use_obj), **kwargs) == route
    assert ttr._route("plain", _batch(0)) == "plain"


def _cos(a, b):
    a, b = np.ravel(a).astype(np.float64), np.ravel(b).astype(np.float64)
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))


def test_cliora_parse_bf16_tracks_jax(cliora):
    """bf16 charts against the JAX f32 parse (the ``loss-chart`` case's
    compile): backpointer agreement, scores and charts by cosine, losses
    within 0.02 + 3 % (tests/test_bf16.py)."""
    jtr, _ = cliora
    _, ttr16 = _pair(True, "bfloat16")
    batch = _batch(1)
    kwargs = dict(compute_loss=True, with_chart=True)
    want, want_m = jtr.parse(batch, **kwargs)
    got, got_m = ttr16.parse(batch, **kwargs)
    assert got["parse_impl"] == "plain"
    assert got["inside_h"].dtype == np.float32
    assert np.mean(got["cky_bp"] == want["cky_bp"]) >= BF16_BP_AGREE
    for k in ("atten_score", "span_scores", "inside_h", "outside_h"):
        assert np.all(np.isfinite(got[k])), k
        assert _cos(got[k], np.asarray(want[k], np.float32)) > BF16_COS, k
    for k in want_m:
        assert abs(got_m[k] - want_m[k]) <= 0.02 + 0.03 * abs(want_m[k]), k


# -- run_eval ---------------------------------------------------------------

def _random_tree(rs, lo, hi):
    if lo == hi:
        return lo
    k = rs.randint(lo, hi)
    return (_random_tree(rs, lo, k), _random_tree(rs, k + 1, hi))


def _eval_batch(seed, length, lengths=None):
    """A batch map as the JAX package's BatchIterator makes it, with gold
    spans (root last), ``VG_GT`` phrases and candidate boxes.  Each
    phrase's gold box is one of its image's boxes, so a phrase is
    grounded when the argmax region is that box."""
    rs = np.random.RandomState(seed)
    batch = _batch(seed, use_obj=True)
    batch["sentences"] = batch["sentences"][:, :length]
    lens = np.full(B, length) if lengths is None else lengths
    lo = rs.uniform(0, 50, (B, R, 2))
    boxes = np.concatenate([lo, lo + rs.uniform(10, 50, (B, R, 2))], -1)
    gt, vg = [], []
    for b in range(B):
        m = int(lens[b])
        gt.append(tree_to_spans(_random_tree(rs, 0, m - 1)))
        phrases = {}
        for p in range(3):
            start = rs.randint(0, m)
            end = min(m, start + 1 + rs.randint(0, 3))
            phrases[f"p{p}"] = (start, end,
                                boxes[b, rs.randint(0, R)].tolist())
        vg.append((phrases, None))
    batch.update({"GT": gt, "VG_GT": vg, "boxes": boxes.astype(np.float32),
                  "length": int(max(lens)), "batch_size": B,
                  "real_size": B, "padded_length": length})
    if lengths is not None:
        batch["lengths"] = lengths
    return batch


class _Iterator:
    def __init__(self, batches):
        self.batches = batches

    def get_iterator(self, random_seed=None):
        del random_seed
        return iter(self.batches)


def _jax_parse_script_ccra(jtr, batches):
    """CCRA as the JAX package's parse script computes it: grounding
    updated with each row's decoded spans (scripts/parse.py:135-146),
    with run_eval's skips (length <= 2, per row when ragged)."""
    meter = JaxGroundingMeter()
    for bm in batches:
        if bm["length"] <= 2:
            continue
        res, _ = jtr.parse(bm, compute_loss=False, outside=True)
        lens = bm.get("lengths", np.full(B, bm["length"]))
        dec = jax_decode_batch(res["cky_bp"], bm["padded_length"], lens)
        for bid, (_, spans) in enumerate(dec):
            if lens[bid] <= 2:
                continue
            meter.update(jax_ground_phrases(
                res["atten_score"][bid], bm["boxes"][bid],
                bm["VG_GT"][bid][0]), set(spans[:-1]))
    return meter.ccra


def test_run_eval_matches_jax(cliora):
    jtr, ttr = cliora
    ragged = _eval_batch(1, L, lengths=LENGTHS)
    # the ``lengths`` case's batch: its parse is compiled already
    ragged["sentences"] = _batch(1)["sentences"]
    ragged["obj_feats"] = _batch(1)["obj_feats"]
    batches = [_eval_batch(3, L), ragged, _eval_batch(5, 2)]
    it = _Iterator(batches)
    want = jax_run_eval(jtr, it, use_obj=True)
    got = run_eval(ttr, it, use_obj=True)
    for k in ("corpus_f1", "sent_f1", "grounding_acc"):
        assert got[k] == want[k], k
    assert want["ccra"] == 0.0          # the JAX run_eval's known delta
    assert got["ccra"] == _jax_parse_script_ccra(jtr, batches)
    assert 0.0 < got["ccra"] <= got["grounding_acc"] <= 1.0
    assert 0.0 < got["corpus_f1"] <= 1.0
