"""Builds the port's CUDA kernels and loads them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled with
``nvcc`` for Hopper (``sm_90a``) into a shared library under
``cliora_tpu_torch/_build/`` at first use -- nothing is built when a
module is imported, and nothing includes PyTorch's headers, so a build
takes seconds.  The library file name carries a hash of the source, of
every shared header ``csrc/*.cuh`` and of the flags, so an edited source
or header is never served by a stale build.

``build`` reports each build's seconds and the ``-Xptxas -v`` lines
(registers, shared memory, spills).
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, Iterable

_PKG = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
]
_BUILD_TIMEOUT_S = 600

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME:
        path = os.path.join(CUDA_HOME, "bin", "nvcc")
        if os.path.exists(path):
            return path
    path = shutil.which("nvcc")
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (set CUDA_HOME or put nvcc on PATH)")
    return path


def _source(name: str) -> str:
    return os.path.join(CSRC, name + ".cu")


def _headers():
    return sorted(glob.glob(os.path.join(CSRC, "*.cuh")))


def lib_path(name: str) -> str:
    """Build output for ``csrc/<name>.cu``, keyed by source, headers and
    flags."""
    h = hashlib.sha1()
    for path in [_source(name), *_headers()]:
        with open(path, "rb") as f:
            h.update(os.path.basename(path).encode())
            h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:16]}.so")


def _ptxas_report(stderr: str):
    keep = ("Compiling entry", "Used", "spill")
    return [line.strip() for line in stderr.splitlines()
            if any(k in line for k in keep)]


def build(names: Iterable[str], force: bool = False) -> Dict[str, dict]:
    """Compile the named sources, one ``nvcc`` process each, all started
    together.

    Skips a source whose library exists unless ``force``.  Returns
    ``{name: {"seconds", "path", "ptxas"}}`` for the sources it built.
    Raises ``RuntimeError`` with the compiler's output if a build fails;
    every process it started has ended when it returns or raises.
    """
    os.makedirs(BUILD_DIR, exist_ok=True)
    todo = [n for n in dict.fromkeys(names)
            if force or not os.path.exists(lib_path(n))]
    jobs = {}
    try:
        for name in todo:
            out = lib_path(name)
            tmp = f"{out}.tmp{os.getpid()}"
            proc = subprocess.Popen(
                [_nvcc(), *NVCC_FLAGS, "-o", tmp, _source(name)],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            jobs[name] = (proc, out, tmp, time.perf_counter())
        built, failed = {}, []
        for name, (proc, out, tmp, t0) in jobs.items():
            stdout, stderr = proc.communicate(timeout=_BUILD_TIMEOUT_S)
            if proc.returncode != 0:
                failed.append(f"{name}: nvcc exit {proc.returncode}\n"
                              f"{stdout}\n{stderr}")
                continue
            os.replace(tmp, out)
            built[name] = {"seconds": time.perf_counter() - t0, "path": out,
                           "ptxas": _ptxas_report(stderr)}
        if failed:
            raise RuntimeError("CUDA kernel build failed: "
                               + "\n".join(failed))
        return built
    finally:
        for proc, _, tmp, _ in jobs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            if os.path.exists(tmp):
                os.unlink(tmp)


def load(name: str) -> ctypes.CDLL:
    """The built library of ``csrc/<name>.cu``, building it on first use."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build([name])
            lib = _LIBS[name] = ctypes.CDLL(lib_path(name))
        return lib
