"""Tensor parallelism of the port on the CPU (the mp cases of
tests/test_parallel.py).

Gloo workers (tests/torch_dp.py, group ``tp``: subprocesses that import
torch and the port only) lay the world out as a ``dp x mp`` grid with
``mp = 2``: two ranks (dp 1) and four (dp 2).  This process holds them
against the port's one-process step, the JAX package's single-device
step and its step over ``make_mesh(4, mp=2)`` on the conftest's virtual
devices, at the JAX tensor-parallel test's tolerances: losses rtol 1e-5,
parameters atol 1e-5 (the cut matmuls add their partial sums in another
order).  As in tests/test_torch_parallel.py, the CLIORA parameters are
held on the entries whose root-mean-square gradient exceeds 1e-6: Adam
moves an entry by about lr whatever the size of its gradient, so an
entry whose gradient is rounding residue (``img_encoder/fc_vis/b``)
carries no contract between two summation orders.
"""

import numpy as np
import pytest

import torch_dp as dp
from cliora_tpu_torch.models.config import ModelConfig
from cliora_tpu_torch.parallel.mesh import Mesh
from cliora_tpu_torch.parallel.sharding import (
    MP_AXIS,
    NO_TP,
    param_specs,
    shard_dims,
    shard_params,
    tensor_parallel,
)
from cliora_tpu_torch.training.checkpoint import flatten, params_from_numpy
from cliora_tpu_torch.training.trainer import (
    TrainConfig,
    Trainer,
    tree_leaves,
    tree_paths,
)

LOSS_RTOL = 1e-5
PARAM_ATOL = 1e-5
ZERO1_ATOL = 1e-6
MOVED_RMS = 1e-6
WORLDS = (2, 4)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Each world's rank records."""
    return {w: dp.launch(tmp_path_factory.mktemp(f"tp{w}"), "tp", world=w)
            for w in WORLDS}


@pytest.fixture(scope="module")
def one_process():
    return {name: dp.run_case(name) for name in ("diora", "cliora")}


@pytest.fixture(scope="module")
def jax_text():
    """The JAX package's three text steps on one device and over
    ``make_mesh(4, mp=2)``: (losses, flat params) each."""
    from cliora_tpu.models.config import ModelConfig as JaxConfig
    from cliora_tpu.parallel.mesh import make_mesh as jax_make_mesh
    from cliora_tpu.training import trainer as jt
    from torch_parity import jax_tree

    model, train, _ = dp.case_configs("diora")
    flat = dp.init_flat("diora")
    out = {}
    for tag, mesh in (("single", None), ("mesh", jax_make_mesh(4, mp=2))):
        tr = jt.Trainer(JaxConfig(**model),
                        jt.TrainConfig(**{**train, "attn_impl": "einsum"}),
                        jax_tree(flat), mesh=mesh)
        ms = [tr.step(b) for b in dp.batches("diora")]
        names = sorted(ms[0])
        from cliora_tpu.training.checkpoint import flatten as jflatten
        out[tag] = (names, np.array([[float(m[k]) for k in names]
                                     for m in ms]),
                    {k: np.asarray(v) for k, v in
                     jflatten(tr.local_params()).items()})
    return out


def _moved(opt, steps=dp.STEPS):
    return {k: np.sqrt(v / (1 - 0.999 ** steps)) > MOVED_RMS
            for k, v in opt["nu"].items()}


def _params(rec, name):
    prefix = f"{name}/param/"
    return {k[len(prefix):]: v for k, v in rec.items()
            if k.startswith(prefix)}


def _spec_configs():
    return {
        "diora": dict(size=16, input_size=24),
        "cliora": dict(size=16, input_size=24, use_obj=True, n_regions=3,
                       obj_feat_size=32),
        "treelstm_compress": dict(size=16, input_size=24, arch="treelstm",
                                  compress=True, share=False),
        "word": dict(size=16, input_size=24, arch="word", use_obj=True,
                     n_regions=3, obj_feat_size=32),
    }


@pytest.mark.parametrize("name", list(_spec_configs()))
def test_param_specs_match_jax(name):
    """The port's Megatron specs equal the JAX package's on the same
    parameter tree (cliora_tpu/parallel/sharding.py:53-85)."""
    from cliora_tpu.parallel.sharding import param_specs as jax_specs

    cfg = ModelConfig(**_spec_configs()[name])
    tr = Trainer.build(cfg, TrainConfig(), 50, device="cpu")
    tree = {}
    for key, arr in flatten(tr.params).items():
        *path, leaf = key.split("/")
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = arr
    want = {k: tuple(v) for k, v in _by_path(jax_specs(tree)).items()}
    got = _by_path(param_specs(tree))
    assert got == want
    assert any(MP_AXIS in s for s in got.values())


def _by_path(tree, prefix=""):
    """``{"a/b": leaf}`` of a nested dict whose leaves are not dicts."""
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items()
                for k, v in _by_path(sub, f"{prefix}{key}/").items()}
    return {prefix[:-1]: tree}


def test_indivisible_dim_replicated_with_warning():
    """D = 12 over mp = 8 (tests/test_parallel.py's case): the D-cut
    leaves are replicated with a "not divisible" warning, E = 24 still
    cuts, and ``tensor_parallel`` says the same."""
    cfg = ModelConfig(size=12, input_size=24)
    params = params_from_numpy(flatten(Trainer.build(
        cfg, TrainConfig(), 50, device="cpu").params), "cpu")
    with pytest.warns(UserWarning, match="not divisible"):
        dims = shard_dims(params, 8)
    flat = dict(zip(tree_paths(dims), tree_leaves(dims)))
    assert flat["diora/inside_compose/fc0/w"] is None
    assert flat["diora/inside_score/mat"] is None
    assert flat["embed/embeddings"] == 1
    assert flat["reconstruct/mat"] == 1
    mesh = Mesh(size=1, rank=0, backend="gloo", mp=8, mp_rank=3)
    mine = shard_params(mesh, params, dims)
    np.testing.assert_array_equal(
        mine["embed"]["embeddings"], params["embed"]["embeddings"][:, 9:12])
    np.testing.assert_array_equal(mine["diora"]["inside_compose"]["fc0"]["w"],
                                  params["diora"]["inside_compose"]["fc0"]["w"])
    tp = tensor_parallel(cfg, mesh)
    assert tp.hidden is None and tp.embed is mesh
    assert tensor_parallel(cfg, None) is NO_TP


@pytest.mark.parametrize("world", WORLDS)
def test_slices(world, ranks):
    """Each rank holds its slice of the cut leaves (fc0 rows, fc1 and the
    score matrix columns, E of the table and projections) and the whole
    replicated ones, in the ``dp x mp`` grid ``rank = d * mp + m``."""
    D, E = dp.D, dp.E
    for r, rec in enumerate(ranks[world]):
        assert list(rec["grid"]) == [world // 2, r // 2, 2, r % 2]
        shapes = {k[len("shape/"):]: tuple(v) for k, v in rec.items()
                  if k.startswith("shape/")}
        assert shapes["diora/inside_compose/fc0/w"] == (D // 2, 2 * D)
        assert shapes["diora/inside_compose/fc0/b"] == (D // 2,)
        assert shapes["diora/inside_compose/fc1/w"] == (D, D // 2)
        assert shapes["diora/inside_compose/fc1/b"] == (D,)
        assert shapes["diora/inside_score/mat"] == (D, D // 2)
        assert shapes["embed/embeddings"] == (dp.V, E // 2)
        assert shapes["reconstruct/mat"] == (D, E // 2)
        assert shapes["diora/root_vector_out_h"] == (D,)


@pytest.mark.parametrize("op", ["compose", "bilinear", "embed",
                                "image_encoder", "reconstruction"])
def test_sharded_ops_match_whole(op, ranks):
    """Each sharded op in a two-rank group against the whole op: its
    output, and the gradients of its weights (gathered) and inputs."""
    val, grads = dp.tp_ops(None)[op]
    for rec in ranks[2]:
        np.testing.assert_allclose(rec[f"tp/{op}/out"],
                                   val.detach().numpy(), rtol=1e-5,
                                   atol=1e-5)
        for k, g in grads.items():
            got = rec[f"tp/{op}/grad/{k}"]
            np.testing.assert_allclose(got, g.numpy(), rtol=1e-5,
                                       atol=1e-5 * np.abs(g.numpy()).max(),
                                       err_msg=f"{op} {k}")


@pytest.mark.parametrize("world", WORLDS)
def test_text_step_matches_jax(world, ranks, one_process, jax_text):
    """The text step over three global batches at (1, 2) and (2, 2):
    losses and whole parameters against the port's one process, the JAX
    single-device step and the JAX step on ``make_mesh(4, mp=2)``."""
    losses, names, flat, _, _ = one_process["diora"]
    for tag in ("single", "mesh"):
        j_names, j_losses, j_flat = jax_text[tag]
        assert j_names == names
        for rec in ranks[world]:
            np.testing.assert_allclose(rec["diora/losses"], j_losses,
                                       rtol=LOSS_RTOL)
            got = _params(rec, "diora")
            assert got.keys() == j_flat.keys()
            for k, v in j_flat.items():
                np.testing.assert_allclose(got[k], v, atol=PARAM_ATOL,
                                           err_msg=f"{tag} {k}")
    for rec in ranks[world]:
        np.testing.assert_allclose(rec["diora/losses"], losses,
                                   rtol=LOSS_RTOL)
        for k, v in flat.items():
            np.testing.assert_allclose(_params(rec, "diora")[k], v,
                                       atol=PARAM_ATOL, err_msg=k)


@pytest.mark.parametrize("world", WORLDS)
def test_cliora_step_matches_one_process_and_descends(world, ranks,
                                                       one_process):
    """The CLIORA step (VG + contrastive on the fused route, K2-K4's plain
    versions here) over three batches against one process, and two steps
    on one batch: finite, the loss descending
    (tests/test_parallel.py:104-115)."""
    losses, names, flat, opt, _ = one_process["cliora"]
    moved = _moved(opt)
    for rec in ranks[world]:
        assert list(rec["cliora/names"]) == names
        np.testing.assert_allclose(rec["cliora/losses"], losses,
                                   rtol=LOSS_RTOL)
        got = _params(rec, "cliora")
        for k, v in flat.items():
            m = moved.get(k, np.ones(v.shape, bool))
            np.testing.assert_allclose(got[k][m], v[m], atol=PARAM_ATOL,
                                       err_msg=k)
        d0, d1 = rec["descend"]
        assert np.isfinite(d0) and np.isfinite(d1) and d1 < d0


@pytest.mark.parametrize("name", ["cliora_treelstm_1step", "cliora_word",
                                  "cliora_dropout"])
def test_other_models_match_one_process(name, ranks):
    """At (1, 2): the TreeLSTM compose (replicated; its score matrix cut,
    the score's inputs copied per pair), the chart-free ``word`` baseline
    (embed and image encoder cut) and attention dropout 0.1 (every mp rank
    draws the dp row's mask) against one process.  The TreeLSTM is held
    on its first step: entries of its embed projection whose first
    gradient is rounding residue move by up to lr either way, and from
    the second step the contrastive loss, which exponentiates the span
    scores, parts by ~3e-5 relative (its first step agrees to 2e-7)."""
    losses, names, flat, opt, _ = dp.run_case(name)
    moved = _moved(opt, 1 if name.endswith("_1step") else dp.STEPS)
    for rec in ranks[2]:
        assert list(rec[f"{name}/names"]) == names
        np.testing.assert_allclose(rec[f"{name}/losses"], losses,
                                   rtol=LOSS_RTOL)
        got = _params(rec, name)
        for k, v in flat.items():
            m = moved.get(k, np.ones(v.shape, bool))
            np.testing.assert_allclose(got[k][m], v[m], atol=PARAM_ATOL,
                                       err_msg=k)


@pytest.mark.parametrize("policy", ["full", "dots", "gathers"])
def test_remat_under_mp_equals_unremated(policy, ranks):
    """Chart levels rematerialized under each policy at (1, 2), their
    all-reduces recomputed in the backward, give the unremated step's
    bits."""
    for rec in ranks[2]:
        base = _params(rec, "cliora_dropout")
        got = _params(rec, f"cliora_dropout_remat_{policy}")
        np.testing.assert_array_equal(
            rec[f"cliora_dropout_remat_{policy}/losses"],
            rec["cliora_dropout/losses"])
        for k, v in base.items():
            np.testing.assert_array_equal(got[k], v, err_msg=k)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", ["diora", "cliora"])
def test_zero1_composes_with_mp(world, name, ranks, one_process):
    """ZeRO-1 over the dp group of the mp-local flat parameters against
    the replicated optimizer at the same grid: parameters and the whole
    Adam moments (tests/test_parallel.py:257-280)."""
    moved = _moved(one_process[name][3])
    for rec in ranks[world]:
        np.testing.assert_allclose(rec[f"{name}_zero1/losses"],
                                   rec[f"{name}/losses"], rtol=1e-6)
        z, r = _params(rec, f"{name}_zero1"), _params(rec, name)
        for k, v in r.items():
            m = moved.get(k, np.ones(v.shape, bool))
            np.testing.assert_allclose(z[k][m], v[m], atol=ZERO1_ATOL,
                                       err_msg=k)
        for part in ("mu", "nu"):
            prefix = f"{name}/opt/{part}/"
            for key in (k for k in rec if k.startswith(prefix)):
                np.testing.assert_allclose(
                    rec[key.replace(f"{name}/", f"{name}_zero1/", 1)],
                    rec[key], atol=1e-6, rtol=1e-5, err_msg=key)


@pytest.mark.parametrize("world", WORLDS)
def test_install_state_keeps_slices(world, ranks):
    """``install_state`` of the trainer's own whole parameters and Adam
    state gives each rank back its slices unchanged
    (tests/test_parallel.py:154-173)."""
    assert all(bool(rec["install_keeps_slices"]) for rec in ranks[world])


@pytest.mark.parametrize("world", WORLDS)
def test_mp_parse_equals_single_plain(world, ranks):
    """The parse under mp takes the plain route and its backpointers equal
    one process's plain route (tests/test_parallel.py:176-185)."""
    tr = dp.trainer("diora")
    want, _ = tr.parse(dp.tp_parse_batch(), impl="plain")
    for rec in ranks[world]:
        assert str(rec["parse/route"]) == "plain"
        np.testing.assert_array_equal(rec["parse/cky_bp"], want["cky_bp"])


def test_mp_needs_a_group():
    """``--mp 2`` in one process without a group raises, naming the launch
    command."""
    from cliora_tpu_torch.parallel.mesh import make_mesh

    with pytest.raises(ValueError, match="mp=2 .*torch.distributed.run"):
        make_mesh(mp=2)


def test_world_not_divisible_by_mp(monkeypatch):
    """A world of 3 ranks cannot form mp groups of 2
    (cliora_tpu/parallel/mesh.py:41's assert)."""
    import torch.distributed as dist

    from cliora_tpu_torch.parallel.mesh import make_mesh

    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_world_size", lambda *a, **k: 3)
    with pytest.raises(ValueError, match="not divisible by mp=2"):
        make_mesh(mp=2)
