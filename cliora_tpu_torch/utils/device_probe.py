"""Bounded card probes (counterpart of cliora_tpu/utils/tpu_probe.py).

A CUDA init that cannot finish (a card lost or held by a hung process)
would block its caller, so :func:`cuda_reachable` runs it in a killable
subprocess with a time limit.  :func:`card_info` reads the card's name,
count and power limit from ``nvidia-smi``: a card may be set below its
maximum power and then runs slower under load, so every measurement is
written beside them.
"""

from __future__ import annotations

import subprocess
import sys
from typing import Dict

_QUERY = ["nvidia-smi", "--query-gpu=name,power.limit",
          "--format=csv,noheader"]


def cuda_reachable(timeout_s: float = 240.0) -> bool:
    """True iff a CUDA init and one allocation on card 0 complete within
    ``timeout_s`` seconds."""
    try:
        r = subprocess.run(
            [sys.executable, "-c",
             "import torch; assert torch.cuda.is_available(); "
             "torch.zeros(1, device='cuda').sum().item()"],
            timeout=timeout_s, capture_output=True)
        return r.returncode == 0
    except (subprocess.TimeoutExpired, OSError):
        return False


def card_info(timeout_s: float = 60.0) -> Dict:
    """``{"line", "name", "power_limit", "count"}``: the first card's
    ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
    line as printed, its two fields, and the number of cards listed.
    Raises where ``nvidia-smi`` fails."""
    out = subprocess.run(_QUERY, capture_output=True, text=True,
                         timeout=timeout_s, check=True)
    lines = [x.strip() for x in out.stdout.strip().splitlines() if x.strip()]
    name, limit = (part.strip() for part in lines[0].rsplit(",", 1))
    return {"line": lines[0], "name": name, "power_limit": limit,
            "count": len(lines)}
