"""Parameter initialization (counterpart of cliora_tpu/models/params.py).

Parameters are nested dicts of tensors with the JAX package's tree and
keys; linear weights use the torch ``(out, in)`` layout.  Every
parameter is drawn from N(0, 1) -- the reference calls
``param.data.normal_()`` on everything after construction
(cliora/net/diora.py:234-237, cliora/net/trainer.py:214-217,41-44) --
and the image encoder of a CLIORA model is zero (cliora/net/utils.py:
45-50); the TreeLSTM gate matrix is scaled by 1/sqrt(2D).  The draws
come from a ``jax.random`` key reproduced in numpy (utils/prng.py) and
follow the JAX package's tree of splits, unused keys included, so a
seed gives the JAX package's initial model (within a few ulp) on every
host and device.
"""

from __future__ import annotations

import numpy as np
import torch

from cliora_tpu_torch.models.config import ModelConfig
from cliora_tpu_torch.utils import prng


def _normal(key, *shape) -> torch.Tensor:
    return torch.from_numpy(prng.normal(key, shape))


def _init_linear(key, out_dim, in_dim):
    kw, kb = prng.split(key)
    return {"w": _normal(kw, out_dim, in_dim), "b": _normal(kb, out_dim)}


def _init_compose(key, cfg: ModelConfig, leaf: bool):
    D = cfg.size
    keys = prng.split(key, 4)
    if cfg.arch == "treelstm":
        # scaled, not N(0, 1): a unit-variance 5D x 2D gate matrix
        # saturates every sigmoid and tanh (cliora_tpu/models/params.py:
        # 34-47); the reference ships no TreeLSTM to match.  An f32
        # multiply by the f32 scale, as the JAX package does
        scale = np.float32(1.0 / np.sqrt(2 * D))
        cp = {"W": _normal(keys[0], 5 * D, 2 * D) * scale,
              "b": torch.zeros(5 * D, dtype=torch.float32)}
        if leaf:
            cp["leaf_fc"] = _init_linear(keys[1], D, D)
            cp["leaf_fc_c"] = _init_linear(keys[2], D, D)
        return cp
    cp = {"fc0": _init_linear(keys[0], D, 2 * D),
          "fc1": _init_linear(keys[1], D, D)}
    if leaf:
        cp["leaf_fc"] = _init_linear(keys[2], D, D)
    return cp


def init_diora_params(key, cfg: ModelConfig):
    """(reference: cliora/net/diora.py:453-471 ``DioraMLP.init_parameters``)

    ``keys[5]`` is never drawn from, and ``keys[2:4]`` only without
    ``share``, as in the JAX package."""
    D = cfg.size
    keys = prng.split(key, 6)
    dp = {
        "inside_compose": _init_compose(keys[0], cfg, leaf=True),
        "inside_score": {"mat": _normal(keys[1], D, D)},
    }
    if not cfg.share:
        dp["outside_compose"] = _init_compose(keys[2], cfg, leaf=False)
        dp["outside_score"] = {"mat": _normal(keys[3], D, D)}
    if cfg.compress:
        dp["root_mat_out"] = _normal(keys[4], D, D)
    else:
        dp["root_vector_out_h"] = _normal(keys[4], D)
    return dp


def init_embed_params(key, cfg: ModelConfig, embeddings):
    """Word embedding table + two projections (span / word).

    (reference: cliora/net/trainer.py:204-224 ``Embed``)

    Args:
      embeddings: (V, E) array of pretrained vectors, or an int V to
        create a trainable table ~ N(0,1) (the ``--emb none`` path).
    """
    D = cfg.size
    k_emb, k_mat, k_mat1 = prng.split(key, 3)
    if isinstance(embeddings, (int, np.integer)):
        table = _normal(k_emb, int(embeddings), cfg.input_size)
    else:
        table = torch.as_tensor(np.asarray(embeddings), dtype=torch.float32)
        if table.shape[1] != cfg.input_size:
            raise ValueError(f"embeddings width {table.shape[1]} != "
                             f"input_size {cfg.input_size}")
    return {
        "embeddings": table,
        "mat": _normal(k_mat, D, cfg.input_size),
        "mat1": _normal(k_mat1, D, cfg.input_size),
    }


def init_image_encoder_params(cfg: ModelConfig):
    """Zero-initialized region-feature projections ("keep same with MAF").

    (reference: cliora/net/utils.py:37-55 ``ImageEncoder``)
    """
    D, F = cfg.size, cfg.obj_feat_size

    def zeros(*shape):
        return torch.zeros(shape, dtype=torch.float32)

    return {
        "fc": {"w": zeros(D, F), "b": zeros(D)},
        "fc_vis": {"w": zeros(D, F), "b": zeros(D)},
    }


def init_recon_params(key, cfg: ModelConfig):
    """(reference: cliora/net/trainer.py:25-44 ReconstructionSoftmaxLoss)"""
    return {"mat": _normal(key, cfg.size, cfg.input_size)}


def to_device(tree, device):
    """Nested dict of tensors -> the same tree on ``device``, as leaf
    tensors outside any autograd graph (sharing storage where ``device``
    is already theirs)."""
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    return tree.detach().to(device)


def init_params(key, cfg: ModelConfig, embeddings, device="cpu"):
    """Full Net parameter tree (reference: cliora/net/trainer.py:227-241).

    Drawn on the host from ``key`` (``utils/prng.py:PRNGKey(seed)``, the
    JAX package's ``jax.random.PRNGKey(seed)``), then moved to
    ``device``.  The ``word`` baseline is chart-free: no ``diora`` or
    ``reconstruct``.
    """
    k_embed, k_diora, k_recon = prng.split(key, 3)
    params = {"embed": init_embed_params(k_embed, cfg, embeddings)}
    if cfg.arch != "word":
        params["diora"] = init_diora_params(k_diora, cfg)
        params["reconstruct"] = init_recon_params(k_recon, cfg)
    if cfg.use_obj:
        params["img_encoder"] = init_image_encoder_params(cfg)
    return to_device(params, device)


def param_count(params) -> int:
    if isinstance(params, dict):
        return sum(param_count(v) for v in params.values())
    return params.numel()
