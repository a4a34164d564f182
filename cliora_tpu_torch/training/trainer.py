"""Trainer: owns the parameters and runs the parse path.

Counterpart of cliora_tpu/training/trainer.py for this slice of the
port: building a model and ``Trainer.parse``, the decode-only text
parse that scripts/parse_diora.py and analysis/eval.py call in the JAX
package.  The optimizer, the losses and the train step come with the
training slice.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import numpy as np
import torch

from cliora_tpu_torch.models.config import ModelConfig
from cliora_tpu_torch.models.diora import (
    diora_forward,
    embed_span,
    leaf_transform,
)
from cliora_tpu_torch.models.params import init_params, to_device
from cliora_tpu_torch.ops import inside_cky


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Optimizer + loss configuration (reference flags:
    cliora/scripts/train.py:337-401).

    The text-only parse reads none of its fields, so it has none yet: the
    optimizer and loss fields arrive with the training slice.
    """


def _default_device() -> torch.device:
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on the GPU unless the caller "
            "asks for the CPU (device='cpu')")
    return torch.device("cuda")


class Trainer:
    """Holds the model config, the parameters and their device.

    (reference: cliora/net/trainer.py:337-501 ``Trainer``)
    """

    def __init__(self, cfg: ModelConfig, tc: TrainConfig, params,
                 device=None):
        self.cfg = cfg
        self.tc = tc
        self.device = (_default_device() if device is None
                       else torch.device(device))
        self.params = to_device(params, self.device)

    @classmethod
    def build(cls, cfg: ModelConfig, tc: TrainConfig, embeddings,
              seed: int = 0, device=None) -> "Trainer":
        """New model with N(0, 1) weights drawn from ``seed``.

        (reference: cliora/net/trainer.py:504-582 ``build_net``)
        ``device=None`` means the CUDA device, and raises without one.
        """
        device = _default_device() if device is None else torch.device(device)
        gen = torch.Generator().manual_seed(seed)
        return cls(cfg, tc, init_params(gen, cfg, embeddings, device),
                   device=device)

    def _route(self, impl: Optional[str], batch_map) -> str:
        impl = impl or self.cfg.parse_impl
        if impl not in ("auto", "plain", "cuda"):
            raise ValueError(f"impl={impl!r}")
        if impl == "auto":
            impl = "cuda" if self.device.type == "cuda" else "plain"
        if impl == "cuda" and self.device.type != "cuda":
            raise ValueError("impl='cuda' needs a trainer on a CUDA device")
        # the fused kernel implements the mlp compose + soft split softmax
        # over full-length sentences only (the JAX package's gating,
        # cliora_tpu/training/trainer.py:745-757)
        if impl == "cuda":
            B, n = np.shape(batch_map["sentences"])
            if (self.cfg.aggregate != "soft"
                    or batch_map.get("lengths") is not None
                    or not inside_cky.supports(n, self.cfg.size, B,
                                               self.cfg.compute_dtype)):
                impl = "plain"
        return impl

    @torch.no_grad()
    def parse(self, batch_map: Dict[str, Any], compute_loss: bool = False,
              outside: Optional[bool] = None, with_chart: bool = False,
              impl: Optional[str] = None):
        """Eval forward with fused CKY.  Returns ``(res, metrics)``: res
        holds numpy ``cky_bp`` (B, ncells) int32 and ``parse_impl``, the
        route that decoded the batch ("cuda" or "plain").

        ``batch_map``: {'sentences': (B, L) int, 'lengths': optional (B,)
        true lengths of a padded batch}.  ``impl`` overrides
        ``cfg.parse_impl``.  The two routes group fc0's sums differently
        (the kernel adds ``W0[:, :D] l`` and ``W0[:, D:] r``; the plain
        chart pass takes one product over ``[l; r]``), so at f32 a near-tie
        split can still pick another backpointer on rare cells; under bf16
        charts the split scores also round at different points.  Published
        trees are therefore attributed to their route.
        """
        if compute_loss:
            raise NotImplementedError(
                "compute_loss: the losses come with the training slice "
                "of the port")
        if with_chart:
            raise NotImplementedError(
                "with_chart: chart outputs come with the training slice "
                "of the port (the outside pass)")
        if outside:
            raise NotImplementedError(
                "outside=True: the outside pass comes with the training "
                "slice of the port")
        route = self._route(impl, batch_map)
        tokens = torch.as_tensor(np.asarray(batch_map["sentences"]),
                                 dtype=torch.int64).to(self.device)
        x_span = embed_span(self.params["embed"], tokens)
        if route == "cuda":
            dp = self.params["diora"]
            h0 = leaf_transform(self.cfg, dp, x_span)
            _, bp, _ = inside_cky.fused_inside_cky(
                dp, h0, norm=self.cfg.normalize,
                compute_dtype=self.cfg.compute_dtype)
        else:
            # padded buckets need no inside mask: inside values of valid
            # cells depend only on valid cells; lengths steer the decode
            bp = diora_forward(self.cfg, self.params, x_span,
                               with_cky=True, outside=False).cky_bp
        return {"cky_bp": bp.cpu().numpy(), "parse_impl": route}, {}

