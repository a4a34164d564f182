"""Static model configuration (counterpart of cliora_tpu/models/config.py).

Mirrors the reference's model flags (reference:
cliora/scripts/train.py:337-345, cliora/net/trainer.py:504-558): the
mlp and TreeLSTM chart composes, the chart-free ``word`` grounding
baseline, and the remat knobs of the chart levels.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    size: int = 400                 # hidden_dim
    input_size: int = 1024          # embedding width E
    # 'mlp' | 'treelstm': chart composes; 'word': the chart-free
    # word-level grounding baseline (reference: cliora/net/vg.py:477-482,
    # dead code there; VG loss only)
    arch: str = "mlp"
    share: bool = True              # tie inside/outside compose+score fns
    normalize: str = "unit"         # 'unit' | 'none'
    compress: bool = False          # outside root = inside root @ mat
    outside: bool = True            # run the outside pass
    use_obj: bool = False           # CLIORA: visual region features
    n_regions: int = 36             # MAF regions per image
    obj_feat_size: int = 2048       # Faster-R-CNN feature width
    attn_dropout: float = 0.1       # AttentionHead dropout (cliora.py:32)
    attn_temp: float = 1.0          # AttentionHead temperature
    compute_dtype: str = "float32"  # matmul/chart dtype (bfloat16 opt-in)
    # rematerialize chart levels in the backward
    # (torch.utils.checkpoint): a level's (B, rows, D) intermediates are
    # recomputed instead of stored.  True/False force it; "auto" decides
    # per batch shape from an activation-memory estimate
    # (ops/chart_pass.py:remat_enabled) against ``remat_budget_gb``
    remat: object = False           # bool | "auto"
    remat_budget_gb: float = 10.0   # device memory "auto" steers under
    # only levels whose intermediates are at least this fraction of the
    # pass's biggest level's are checkpointed (0.0: every level)
    remat_frac: float = 0.0
    # what a checkpointed level keeps for its backward: 'full' its inputs
    # only; 'dots' also the outputs of its matrix products; 'gathers'
    # everything but the chart-child gathers (a measured negative in the
    # JAX package, kept for flag parity)
    remat_policy: str = "full"
    # 'soft': softmax-weighted split aggregation (DIORA); 'hard': argmax
    # split only (the S-DIORA greedy variant)
    aggregate: str = "soft"
    # 'auto': the fused CUDA inside+CKY kernel (ops/inside_cky.py) for a
    # CUDA device, the plain PyTorch inside pass (ops/chart_pass.py) for
    # a CPU device.  'plain' / 'cuda' force one route; 'cuda' is taken
    # only where the kernel supports the batch (text-only mlp decode).
    parse_impl: str = "auto"

    def __post_init__(self):
        if self.arch not in ("mlp", "treelstm", "word"):
            raise ValueError(f"arch={self.arch!r}")
        if self.arch == "word" and not self.use_obj:
            raise ValueError("--arch word is a grounding baseline; it "
                             "requires --obj_feats")
        if self.normalize not in ("unit", "none"):
            raise ValueError(f"normalize={self.normalize!r}")
        if self.compute_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"compute_dtype={self.compute_dtype!r}")
        if self.aggregate not in ("soft", "hard"):
            raise ValueError(f"aggregate={self.aggregate!r}")
        if self.remat not in (True, False, "auto"):
            raise ValueError(f"remat={self.remat!r}")
        if self.remat_policy not in ("full", "dots", "gathers"):
            raise ValueError(f"remat_policy={self.remat_policy!r}")
        if self.parse_impl not in ("auto", "plain", "cuda"):
            raise ValueError(f"parse_impl={self.parse_impl!r}")
        if not 0.0 <= self.attn_dropout < 1.0:
            raise ValueError(f"attn_dropout={self.attn_dropout!r}")
