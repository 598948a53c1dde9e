"""The paged-attention CUDA kernels: build, bind, launch, count.

``csrc/paged_attention.cu`` holds two hand-written kernels for Hopper
(``sm_90a``). They are compiled with ``nvcc`` into a shared library with a
plain C interface at first use, under ``build/opsagent_tpu_torch/`` in the
checkout, and bound with ``ctypes``; nothing is compiled when this module is
imported.

Each wrapper takes its kernel's plain PyTorch version (``ops/attention.py``)
for CPU tensors, or when the caller passes ``plain=True`` (the explicit way
to build a reference on the card). For CUDA tensors it launches the kernel
on the current stream or raises; there is no fallback. ``LAUNCHES`` counts
the kernel launches of each wrapper.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

from .attention import paged_decode_attention, paged_ragged_attention

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "paged_attention.cu"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "opsagent_tpu_torch"
HEAD_DIMS = (16, 32, 64, 128)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

LAUNCHES: dict[str, int] = {
    "paged_ragged_attention": 0,
    "paged_decode_attention": 0,
}

_lib: ctypes.CDLL | None = None
_lib_lock = threading.Lock()


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if path.exists():
        return str(path)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def build(verbose: bool = False) -> tuple[Path, str]:
    """Compile the kernels if this source has not been built yet. Returns
    (library path, compiler output; with ``verbose`` it includes ptxas's
    register and shared-memory report). The library name carries a hash of
    the source, so an edited source never loads a stale build."""
    digest = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:16]
    lib = BUILD_DIR / f"libpaged_attention_{digest}.so"
    if lib.exists() and not verbose:
        return lib, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [
        _nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
        "-O3", "-shared", "-Xcompiler", "-fPIC", "-o", str(tmp), str(SOURCE),
    ]
    if verbose:
        cmd[1:1] = ["-Xptxas", "-v"]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({res.returncode}):\n{res.stdout}\n{res.stderr}"
        )
    os.replace(tmp, lib)
    return lib, res.stdout + res.stderr


def _library() -> ctypes.CDLL:
    global _lib
    with _lib_lock:
        if _lib is None:
            path, _ = build()
            lib = ctypes.CDLL(str(path))
            p, i = ctypes.c_void_p, ctypes.c_int
            lib.opsagent_paged_ragged_attention.argtypes = (
                [p] * 7 + [i] * 7 + [ctypes.c_float, i, p]
            )
            lib.opsagent_paged_ragged_attention.restype = i
            lib.opsagent_paged_decode_attention.argtypes = (
                [p] * 6 + [i] * 6 + [ctypes.c_float, i, p]
            )
            lib.opsagent_paged_decode_attention.restype = i
            _lib = lib
        return _lib


def _layer_view(pages: torch.Tensor, layer: int | None) -> torch.Tensor:
    """[L, N, P, K, D] + layer -> that layer's contiguous [N, P, K, D] view."""
    return pages[layer or 0] if pages.ndim == 5 else pages


def _check(
    q: torch.Tensor, k_pages: torch.Tensor, v_pages: torch.Tensor,
    ints: dict[str, torch.Tensor], batch: int,
) -> None:
    """Raise on anything the kernels do not take."""
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"q dtype {q.dtype}: the kernels take float32 or bfloat16")
    for name, t in (("k_pages", k_pages), ("v_pages", v_pages)):
        if t.dtype != q.dtype:
            raise TypeError(f"{name} dtype {t.dtype} != q dtype {q.dtype}")
        if t.ndim != 4 or t.shape != k_pages.shape:
            raise ValueError(f"{name} shape {tuple(t.shape)}: expected [N, P, K, D]")
    N, P, K, D = k_pages.shape
    H = q.shape[-2]
    if q.shape[-1] != D or D not in HEAD_DIMS:
        raise ValueError(f"head dim {q.shape[-1]} (pages {D}): expected one of {HEAD_DIMS}")
    if H % K:
        raise ValueError(f"{H} query heads are not a multiple of {K} kv heads")
    floats = (("q", q), ("k_pages", k_pages), ("v_pages", v_pages))
    for name, t in (*floats, *ints.items()):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, t in floats:
        if t.data_ptr() % 16:  # the kernels load rows 16 bytes at a time
            raise ValueError(f"{name} must be 16-byte aligned")
    for name, t in ints.items():
        if t.dtype != torch.int32:
            raise TypeError(f"{name} dtype {t.dtype}: expected int32")
        if t.shape[0] != batch:
            raise ValueError(f"{name} has {t.shape[0]} rows, batch is {batch}")


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def _raise_on(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")


def paged_ragged_attention_cuda(
    q: torch.Tensor,            # [B, S, H, D]
    k_pages: torch.Tensor,      # [N, P, K, D] or [L, N, P, K, D] with layer
    v_pages: torch.Tensor,
    page_table: torch.Tensor,   # [B, MaxP] int32
    start: torch.Tensor,        # [B] int32
    q_lens: torch.Tensor,       # [B] int32
    layer: int | None = None,
    plain: bool = False,
) -> torch.Tensor:
    """Ragged paged attention (``ops.attention.paged_ragged_attention``'s
    contract) through the CUDA kernel."""
    if plain or q.device.type == "cpu":
        return paged_ragged_attention(
            q, k_pages, v_pages, page_table, start, q_lens, layer=layer
        )
    k_pages, v_pages = _layer_view(k_pages, layer), _layer_view(v_pages, layer)
    B, S, H, D = q.shape
    ints = {"page_table": page_table, "start": start, "q_lens": q_lens}
    _check(q, k_pages, v_pages, ints, B)
    N, P, K, _ = k_pages.shape
    out = torch.empty_like(q)
    rc = _library().opsagent_paged_ragged_attention(
        _ptr(q), _ptr(k_pages), _ptr(v_pages), _ptr(page_table), _ptr(start),
        _ptr(q_lens), _ptr(out), B, S, H, K, D, P, page_table.shape[1],
        D ** -0.5, _DTYPE_CODES[q.dtype],
        ctypes.c_void_p(torch.cuda.current_stream(q.device).cuda_stream),
    )
    _raise_on(rc, "paged_ragged_attention")
    LAUNCHES["paged_ragged_attention"] += 1
    return out


def paged_decode_attention_cuda(
    q: torch.Tensor,            # [B, H, D]
    k_pages: torch.Tensor,      # [N, P, K, D] or [L, N, P, K, D] with layer
    v_pages: torch.Tensor,
    page_table: torch.Tensor,   # [B, MaxP] int32
    lengths: torch.Tensor,      # [B] int32, including the new token
    layer: int | None = None,
    plain: bool = False,
) -> torch.Tensor:
    """Paged decode attention (``ops.attention.paged_decode_attention``'s
    contract) through the CUDA kernel."""
    if plain or q.device.type == "cpu":
        return paged_decode_attention(
            q, k_pages, v_pages, page_table, lengths, layer=layer
        )
    k_pages, v_pages = _layer_view(k_pages, layer), _layer_view(v_pages, layer)
    B, H, D = q.shape
    ints = {"page_table": page_table, "lengths": lengths}
    _check(q, k_pages, v_pages, ints, B)
    N, P, K, _ = k_pages.shape
    out = torch.empty_like(q)
    rc = _library().opsagent_paged_decode_attention(
        _ptr(q), _ptr(k_pages), _ptr(v_pages), _ptr(page_table), _ptr(lengths),
        _ptr(out), B, H, K, D, P, page_table.shape[1],
        D ** -0.5, _DTYPE_CODES[q.dtype],
        ctypes.c_void_p(torch.cuda.current_stream(q.device).cuda_stream),
    )
    _raise_on(rc, "paged_decode_attention")
    LAUNCHES["paged_decode_attention"] += 1
    return out
