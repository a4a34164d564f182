"""Native host-runtime components (C, CPython API).

The port's own copy of cliora_tpu/native: the batch CKY backpointer
decode (``_fasttrees.c``).  It is compiled lazily with the system C
compiler on first use, into the port's build directory
(``cliora_tpu_torch/_build/``, ignored by git), under a name keyed by
the source's hash and the interpreter's extension suffix; the build
writes a temporary file and renames it, so concurrent processes race
safely.  :func:`load` returns ``None`` when no compiler is available and
callers fall back to the python decoder (analysis/trees.py), which
records that it ran.
"""

from __future__ import annotations

import hashlib
import importlib.util
import os
import subprocess
import sysconfig
import threading
from typing import Optional

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "_fasttrees.c")
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")
_CACHE = "unset"  # tri-state: "unset" | None (unavailable) | module
_LOCK = threading.Lock()  # one build/import per process at a time


def _so_path() -> str:
    with open(_SRC, "rb") as f:
        digest = hashlib.sha1(f.read()).hexdigest()[:16]
    suffix = sysconfig.get_config_var("EXT_SUFFIX") or ".so"
    return os.path.join(BUILD_DIR, f"fasttrees-{digest}",
                        "_fasttrees" + suffix)


def _build(out: str) -> None:
    os.makedirs(os.path.dirname(out), exist_ok=True)
    tmp = out + f".tmp{os.getpid()}.{threading.get_ident()}"
    cc = os.environ.get("CC", "cc")
    cmd = [cc, "-O2", "-fPIC", "-shared",
           "-I", sysconfig.get_path("include"), _SRC, "-o", tmp]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def load() -> Optional[object]:
    """The compiled ``_fasttrees`` module, building it on first use.

    Returns None when it cannot be built (no C compiler, no Python
    headers); the result, failure included, is cached for the process.
    """
    global _CACHE
    with _LOCK:
        if _CACHE != "unset":
            return _CACHE
        path = _so_path()
        try:
            if not os.path.exists(path):
                _build(path)
            spec = importlib.util.spec_from_file_location(
                "cliora_tpu_torch.native._fasttrees", path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            _CACHE = mod
        except (OSError, ImportError, subprocess.SubprocessError):
            _CACHE = None
        return _CACHE
