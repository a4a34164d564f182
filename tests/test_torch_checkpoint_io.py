"""Parameter checkpoints cross between the packages: the native ``.npz``
and the reference's ``{'state_dict': ...}`` ``.pt``, written by either
package and read by the other, and the trees parsed after the trip."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cliora_tpu.models.config import ModelConfig as JaxConfig
from cliora_tpu.models.params import init_params as jax_init_params
from cliora_tpu.training import checkpoint as jck
from cliora_tpu.training import trainer as jt
from cliora_tpu_torch.models.config import ModelConfig
from cliora_tpu_torch.models.params import init_params
from cliora_tpu_torch.training import checkpoint as tck
from cliora_tpu_torch.training import trainer as tt

D, E, V, R, F = 16, 24, 50, 4, 32
B, L = 4, 5
IMG_KEYS = {"img_encoder/fc/w", "img_encoder/fc/b",
            "img_encoder/fc_vis/w", "img_encoder/fc_vis/b"}


def _cfg(use_obj=True, share=True):
    kw = dict(size=D, input_size=E, share=share)
    if use_obj:
        kw.update(use_obj=True, n_regions=R, obj_feat_size=F,
                  attn_dropout=0.0)
    return JaxConfig(**kw), ModelConfig(**kw)


def _jax_params(use_obj=True, share=True, seed=3):
    params = jax_init_params(jax.random.PRNGKey(seed), _cfg(use_obj, share)[0],
                             V)
    if "img_encoder" in params:
        key = jax.random.PRNGKey(seed + 1)
        params["img_encoder"] = jax.tree.map(
            lambda x: 0.01 * jax.random.normal(key, x.shape),
            params["img_encoder"])
    return params


def _port_template(use_obj=True, share=True, seed=11):
    return init_params(torch.Generator().manual_seed(seed),
                       _cfg(use_obj, share)[1], V)


def _jax_template(use_obj=True, share=True):
    return jax.tree.map(jnp.zeros_like, _jax_params(use_obj, share))


def _assert_same_bits(got, want, skip=()):
    assert set(got) == set(want)
    for k in want:
        if k not in skip:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _batch():
    rs = np.random.RandomState(0)
    return {"sentences": rs.randint(2, V, (B, L)),
            "obj_feats": rs.randn(B, R, F).astype(np.float32)}


def test_jax_npz_loads_into_the_port_and_parses_as_jax(tmp_path):
    params = _jax_params()
    path = os.path.join(tmp_path, "model.npz")
    jck.save_params(path, params, extra={"epoch": 3, "step": 120})
    loaded, missing = tck.load_params(path, _port_template())
    assert missing == []
    _assert_same_bits(tck.flatten(loaded), jck.flatten(params))
    jcfg, cfg = _cfg()
    want, _ = jt.Trainer(jcfg, jt.TrainConfig(), params).parse(_batch())
    got, _ = tt.Trainer(cfg, tt.TrainConfig(), loaded,
                        device="cpu").parse(_batch())
    np.testing.assert_array_equal(got["cky_bp"], want["cky_bp"])
    np.testing.assert_allclose(got["atten_score"], want["atten_score"],
                               atol=1e-5)


@pytest.mark.parametrize("save_embeddings", [True, False])
def test_port_npz_loads_into_jax(tmp_path, save_embeddings):
    params = _port_template(seed=5)
    path = os.path.join(tmp_path, "model.npz")
    tck.save_params(path, params, save_embeddings=save_embeddings,
                    extra={"epoch": 1})
    with np.load(path) as z:
        assert "__extra__/epoch" in z.files
    template = _jax_template()
    loaded, missing = jck.load_params(path, template)
    want = tck.flatten(params)
    got = jck.flatten(loaded)
    if save_embeddings:
        assert missing == []
        _assert_same_bits(got, want)
    else:
        assert missing == ["embed/embeddings"]
        _assert_same_bits(got, want, skip={"embed/embeddings"})
        assert not np.any(got["embed/embeddings"])
    # and back: the port reads its own file, extras left out
    again, missing = tck.load_params(path, _port_template(seed=6))
    _assert_same_bits(tck.flatten(again), want,
                      skip=() if save_embeddings else {"embed/embeddings"})


def _ddp(path):
    """The same checkpoint as a DDP-wrapped model saves it."""
    blob = torch.load(path, weights_only=True)
    ddp = path.replace(".pt", ".ddp.pt")
    torch.save({"state_dict": {"module." + k: v
                               for k, v in blob["state_dict"].items()}}, ddp)
    return ddp


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("share", [True, False])
def test_torch_checkpoint_crosses(tmp_path, writer, share):
    path = os.path.join(tmp_path, "ref.pt")
    if writer == "jax":
        params = _jax_params(share=share)
        want = jck.flatten(params)
        jck.export_torch_checkpoint(path, params)
        read = lambda p: tck.import_torch_checkpoint(      # noqa: E731
            p, _port_template(share=share))
        flat = tck.flatten
    else:
        params = _port_template(share=share, seed=7)
        want = tck.flatten(params)
        tck.export_torch_checkpoint(path, params)
        read = lambda p: jck.import_torch_checkpoint(      # noqa: E731
            p, _jax_template(share=share))
        flat = jck.flatten
    sd = torch.load(path, weights_only=True)["state_dict"]
    assert "diora.outside_score_func.mat" in sd
    if share:
        # share=True: the outside names alias the inside tensors
        for inside, outside in (
                ("diora.inside_score_func.mat",
                 "diora.outside_score_func.mat"),
                ("diora.inside_compose_func.leaf_fc.weight",
                 "diora.outside_compose_func.leaf_fc.weight")):
            assert torch.equal(sd[inside], sd[outside])
    else:
        assert "diora.outside_compose_func.leaf_fc.weight" not in sd
    for p in (path, _ddp(path)):
        loaded, missing = read(p)
        assert missing == []
        _assert_same_bits(flat(loaded), want)


def test_torch_checkpoint_keeps_embeddings_when_asked(tmp_path):
    path = os.path.join(tmp_path, "ref.pt")
    params = _jax_params()
    jck.export_torch_checkpoint(path, params)
    template = _port_template(seed=8)
    loaded, missing = tck.import_torch_checkpoint(path, template,
                                                  load_embeddings=False)
    assert missing == ["embed/embeddings"]
    assert torch.equal(loaded["embed"]["embeddings"],
                       template["embed"]["embeddings"])
    _assert_same_bits(tck.flatten(loaded), jck.flatten(params),
                      skip={"embed/embeddings"})


@pytest.mark.parametrize("fmt", ["npz", "pt"])
def test_diora_checkpoint_warm_starts_a_cliora_model(tmp_path, fmt):
    """Missing keys keep the template's value: a text-only checkpoint
    leaves the zero-init image encoder at zero."""
    diora = _port_template(use_obj=False, seed=9)
    path = os.path.join(tmp_path, "diora." + fmt)
    if fmt == "npz":
        tck.save_params(path, diora)
        load = tck.load_params
    else:
        tck.export_torch_checkpoint(path, diora)
        load = tck.import_torch_checkpoint
    template = _port_template(seed=10)
    assert not any(np.any(v) for k, v in tck.flatten(template).items()
                   if k in IMG_KEYS)
    warm, missing = load(path, template)
    assert set(missing) == IMG_KEYS
    got = tck.flatten(warm)
    assert all(not np.any(got[k]) for k in IMG_KEYS)
    want = tck.flatten(diora)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
