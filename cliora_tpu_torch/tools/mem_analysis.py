"""Memory of one train step for a given config, measured on the card (the
port's counterpart of tools/mem_analysis.py).

Torch has no compile-time memory analysis, so this runs the step: it
builds the bench trainer (B x L, D=400, E=1,024, V=10,000 trainable,
k_neg 100, 36 x 2,048-d regions, bf16, ``attn_impl="cuda"``; ``text``
drops the regions and the visual losses), resets the peak counter and
runs one eager step.  It prints the peak above what the trainer holds
(``peak_gb``), the parameter and optimizer bytes, the ``--remat auto``
estimate (ops/chart_pass.py ``activation_estimate_bytes``:
``_ACT_COPY_FACTOR * B * D * (n^3 - n)/2 * itemsize``) and the measured
copy factor, the peak over one chart-dtype copy of the gathered children
(``chart_bytes``): the number ``_ACT_COPY_FACTOR`` is calibrated from.

Usage::

    python -m cliora_tpu_torch.tools.mem_analysis \\
        '{"B":128,"L":40,"remat":true,"policy":"gathers","text":true}'

It needs ``torch.cuda.max_memory_allocated``, so it refuses on the CPU,
``--device cpu`` included.
"""

from __future__ import annotations

import argparse
import dataclasses
import json

import numpy as np
import torch

from cliora_tpu_torch.models.config import ModelConfig
from cliora_tpu_torch.ops import chart_pass
from cliora_tpu_torch.tools import common
from cliora_tpu_torch.tools.common import D, E, F, KNEG, R, V
from cliora_tpu_torch.training.trainer import (
    TrainConfig,
    Trainer,
    tree_leaves,
)

GB = 2 ** 30


def configs(spec):
    """The spec's model and train configs (tools/mem_analysis.py:32-42)."""
    text = spec.get("text", False)
    cfg = ModelConfig(size=D, input_size=E, use_obj=not text, n_regions=R,
                      obj_feat_size=F, compute_dtype="bfloat16",
                      remat=spec.get("remat", False),
                      remat_frac=spec.get("remat_frac", 0.0),
                      remat_policy=spec.get("policy", "full"))
    tc = TrainConfig(lr=5e-4, k_neg=KNEG, vg_loss=not text,
                     use_contr=not text, emb_trainable=True,
                     attn_impl="cuda")
    return cfg, tc


def estimate(cfg, B, L):
    """The ``--remat auto`` numbers of a (B, L) step: one chart copy's
    bytes, the estimate's, and whether ``auto`` would remat it."""
    auto = dataclasses.replace(cfg, remat="auto")
    return {"chart_gb": chart_pass.chart_bytes(cfg, B, L, D) / GB,
            "estimate_gb":
                chart_pass.activation_estimate_bytes(cfg, B, L, D) / GB,
            "port_factor": chart_pass._ACT_COPY_FACTOR,
            "budget_gb": cfg.remat_budget_gb,
            "auto_remat": chart_pass.remat_enabled(auto, B, L, D)}


def state_bytes(trainer):
    """Bytes of the parameters and of Adam's state."""
    params = sum(p.numel() * p.element_size()
                 for p in tree_leaves(trainer.params))
    opt = sum(t.numel() * t.element_size()
              for st in trainer.optimizer.state.values()
              for t in st.values() if isinstance(t, torch.Tensor))
    return {"param_gb": params / GB, "optimizer_gb": opt / GB}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("spec", nargs="?", default="{}",
                    help='JSON: {"B", "L", "remat", "remat_frac", '
                         '"policy", "text"}')
    common.add_device_flag(ap)
    args = ap.parse_args(argv)
    if (torch.device(args.device or "cuda").type != "cuda"
            or not torch.cuda.is_available()):
        common.refuse("mem_analysis measures torch.cuda.max_memory_allocated:"
                      " it needs a CUDA device (--device cpu has no "
                      "counterpart)")
    dev = common.device_for(args.device)
    spec = json.loads(args.spec)
    B, L = spec.get("B", 128), spec.get("L", 40)
    cfg, tc = configs(spec)
    trainer = Trainer.build(cfg, tc, V, seed=0, device=dev)
    rs = np.random.RandomState(0)
    batch = {"sentences": rs.randint(0, V, (B, L)),
             "neg_samples": rs.choice(V, KNEG, replace=False)}
    if cfg.use_obj:
        batch["obj_feats"] = rs.randn(B, R, F).astype(np.float32)
    batch = {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}
    common.sync(dev)
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    loss = float(trainer.step(batch)["total_loss"])
    common.sync(dev)
    peak = torch.cuda.max_memory_allocated(dev) - base
    est = estimate(cfg, B, L)
    out = {"B": B, "L": L, "policy": spec.get("policy", "full"),
           "remat": spec.get("remat", False),
           "remat_frac": spec.get("remat_frac", 0.0),
           "text": spec.get("text", False),
           "peak_gb": peak / GB, **state_bytes(trainer), **est,
           "measured_factor": peak / GB / est["chart_gb"],
           "loss_finite": bool(np.isfinite(loss)),
           **common.device_record(dev)}
    common.emit(out)


if __name__ == "__main__":
    main()
