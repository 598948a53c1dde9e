"""Build and bind the port's hand-written CUDA kernels.

Each ``csrc/*.cu`` source is compiled on its own with ``nvcc -gencode
arch=compute_90a,code=sm_90a`` into a shared library with a plain C
interface, at first use, under ``build/opsagent_tpu_torch/`` in the
checkout, and loaded with ``ctypes``. Nothing is compiled when a module is
imported. The library name carries a hash of its source and of the shared
``csrc/*.cuh`` headers, so an edited source never loads a stale build.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Callable

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "opsagent_tpu_torch"

_libs: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if path.exists():
        return str(path)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def build(source: str, verbose: bool = False) -> tuple[Path, str]:
    """Compile ``csrc/<source>`` if this version of it has not been built
    yet. Returns (library path, compiler output; with ``verbose`` it
    includes ptxas's register and shared-memory report)."""
    src = CSRC / source
    # The shared headers are part of every source's build.
    text = [src.read_bytes()] + [h.read_bytes() for h in sorted(CSRC.glob("*.cuh"))]
    digest = hashlib.sha256(b"".join(text)).hexdigest()[:16]
    lib = BUILD_DIR / f"lib{src.stem}_{digest}.so"
    if lib.exists() and not verbose:
        return lib, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [
        _nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
        "-O3", "-shared", "-Xcompiler", "-fPIC", "-o", str(tmp), str(src),
    ]
    if verbose:
        cmd[1:1] = ["-Xptxas", "-v"]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(
            f"nvcc {source} failed ({res.returncode}):\n{res.stdout}\n{res.stderr}"
        )
    os.replace(tmp, lib)
    return lib, res.stdout + res.stderr


def library(source: str, bind: Callable[[ctypes.CDLL], None]) -> ctypes.CDLL:
    """The loaded library of ``csrc/<source>``, built at first use;
    ``bind`` sets its functions' argument and return types once."""
    with _lock:
        lib = _libs.get(source)
        if lib is None:
            path, _ = build(source)
            lib = ctypes.CDLL(str(path))
            bind(lib)
            _libs[source] = lib
        return lib


def ptr(t: torch.Tensor | None) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr() if t is not None else 0)


def stream(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def raise_on(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")
