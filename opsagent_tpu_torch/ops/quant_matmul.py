"""Weight-only quantized matmul: plain version and the CUDA kernels.

``quant_matmul(x, w) = x @ w.dequantize().to(x.dtype)`` is the JAX oracle's
math (``opsagent_tpu/models/llama.py`` ``_mm``): each weight element is
dequantized in f32, cast to x's dtype, and the product accumulates in f32.

``csrc/quant_matmul.cu`` holds the hand-written kernels for Hopper
(``sm_90a``) that replace ``quant_matmul_pallas``
(``opsagent_tpu/ops/quant_matmul_pallas.py``), int8 and packed-int4 bodies,
for bf16 and f32 activations. ``quant_matmul_cuda`` takes the plain version
for CPU tensors or ``plain=True``; on a CUDA tensor it launches the kernel
on the current stream or raises. ``LAUNCHES`` counts its launches by
weight width.
"""

from __future__ import annotations

import ctypes

import torch

from ..models.quant import QuantizedBase, QuantizedLinear, QuantizedLinear4
from . import cuda_build

SOURCE = "quant_matmul.cu"
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

LAUNCHES: dict[str, int] = {
    "quant_matmul_int8": 0,
    "quant_matmul_int4": 0,
}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _bind(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.opsagent_quant_matmul.argtypes = [p] * 4 + [i] * 6 + [p]
    lib.opsagent_quant_matmul.restype = i


def quant_matmul(x: torch.Tensor, w: QuantizedBase) -> torch.Tensor:
    """The plain version: ``x @ w.dequantize().to(x.dtype)``."""
    return x @ w.dequantize().to(x.dtype)


def _check(x: torch.Tensor, w: QuantizedBase) -> None:
    """Raise on anything the kernels do not take."""
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"x dtype {x.dtype}: the kernels take float32 or bfloat16")
    if x.ndim != 2:
        raise ValueError(f"x must be [T, In], got {tuple(x.shape)}")
    In, Out = w.shape
    if x.shape[1] != In:
        raise ValueError(f"x In={x.shape[1]} != weight In={In}")
    if w.q.dtype != torch.int8 or w.scale.dtype != torch.float32:
        raise TypeError(f"weight codes {w.q.dtype} / scales {w.scale.dtype}: "
                        "expected int8 / float32")
    want = (1, Out) if isinstance(w, QuantizedLinear) else (w.scale.shape[0], 1, Out)
    if tuple(w.scale.shape) != want or In % w.scale.shape[0]:
        raise ValueError(f"scale shape {tuple(w.scale.shape)} for weight [{In}, {Out}]")
    for name, t in (("x", x), ("q", w.q), ("scale", w.scale)):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:  # the kernels load 16 bytes at a time
            raise ValueError(f"{name} must be 16-byte aligned")


def quant_matmul_cuda(
    x: torch.Tensor,            # [T, In] bfloat16 or float32
    w: QuantizedBase,           # QuantizedLinear [In, Out] or QuantizedLinear4
    plain: bool = False,
) -> torch.Tensor:
    """``quant_matmul`` through the CUDA kernel: [T, Out] in x's dtype."""
    if plain or x.device.type == "cpu":
        return quant_matmul(x, w)
    if not isinstance(w, (QuantizedLinear, QuantizedLinear4)):
        raise TypeError(f"unsupported quantized weight: {type(w)!r}")
    _check(x, w)
    T, In = x.shape
    Out = w.shape[1]
    bits = 4 if isinstance(w, QuantizedLinear4) else 8
    group = w.group if bits == 4 else In
    y = torch.empty((T, Out), dtype=x.dtype, device=x.device)
    rc = cuda_build.library(SOURCE, _bind).opsagent_quant_matmul(
        cuda_build.ptr(x), cuda_build.ptr(w.q), cuda_build.ptr(w.scale),
        cuda_build.ptr(y), T, In, Out, bits, group, _DTYPE_CODES[x.dtype],
        cuda_build.stream(x.device),
    )
    name = f"quant_matmul_int{bits}"
    cuda_build.raise_on(rc, name)
    LAUNCHES[name] += 1
    return y
