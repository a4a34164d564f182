"""Static model configuration (counterpart of cliora_tpu/models/config.py).

Mirrors the reference's model flags (reference:
cliora/scripts/train.py:337-345, cliora/net/trainer.py:504-558).  The
remat knobs and the TreeLSTM arch are not carried over; the CLIORA
visual path (``use_obj``) and the ``word`` baseline arrive with later
slices of the port and raise until then.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    size: int = 400                 # hidden_dim
    input_size: int = 1024          # embedding width E
    arch: str = "mlp"               # chart compose function
    share: bool = True              # tie inside/outside compose+score fns
    normalize: str = "unit"         # 'unit' | 'none'
    compress: bool = False          # outside root = inside root @ mat
    outside: bool = True            # run the outside pass
    use_obj: bool = False           # CLIORA: visual region features
    compute_dtype: str = "float32"  # matmul/chart dtype (bfloat16 opt-in)
    # 'soft': softmax-weighted split aggregation (DIORA); 'hard': argmax
    # split only (the S-DIORA greedy variant)
    aggregate: str = "soft"
    # 'auto': the fused CUDA inside+CKY kernel (ops/inside_cky.py) for a
    # CUDA device, the plain PyTorch inside pass (ops/chart_pass.py) for
    # a CPU device.  'plain' / 'cuda' force one route; 'cuda' is taken
    # only where the kernel supports the batch (text-only decode).
    parse_impl: str = "auto"

    def __post_init__(self):
        if self.arch != "mlp":
            raise NotImplementedError(
                f"arch={self.arch!r}: the port runs the mlp compose only; "
                "the treelstm and word archs come with a later slice")
        if self.use_obj:
            raise NotImplementedError(
                "use_obj=True: the CLIORA visual path (region attention, "
                "outside pass, span x region kernels) comes with the "
                "CLIORA slice of the port")
        if self.normalize not in ("unit", "none"):
            raise ValueError(f"normalize={self.normalize!r}")
        if self.compute_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"compute_dtype={self.compute_dtype!r}")
        if self.aggregate not in ("soft", "hard"):
            raise ValueError(f"aggregate={self.aggregate!r}")
        if self.parse_impl not in ("auto", "plain", "cuda"):
            raise ValueError(f"parse_impl={self.parse_impl!r}")
