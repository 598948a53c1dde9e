"""Weight-only quantized matmul: plain version and the CUDA kernels.

``quant_matmul(x, w) = x @ w.dequantize().to(x.dtype)`` is the JAX oracle's
math (``opsagent_tpu/models/llama.py`` ``_mm``): each weight element is
dequantized in f32, cast to x's dtype, and the product accumulates in f32.

``csrc/quant_matmul.cu`` holds the hand-written kernels for Hopper
(``sm_90a``) that replace ``quant_matmul_pallas``
(``opsagent_tpu/ops/quant_matmul_pallas.py``), int8 and packed-int4 bodies,
for bf16 and f32 activations. ``quant_matmul_cuda`` takes the plain version
for CPU tensors or ``plain=True``; on a CUDA tensor it launches the kernel
on the current stream or raises. ``plan`` picks the kernel's instance from
shapes alone: ``m128`` (bf16, T > 16: the mixed ticks, every projection of
the served models), ``m16`` (bf16, T <= 16: decode steps and the lm_head,
the contraction axis split over ``split_k`` blocks), ``m64`` and ``r16``
(bf16, T > 16 and T <= 16 at shapes the first two do not take) or ``f32``.
``LAUNCHES`` counts launches by weight width, ``INSTANCE_LAUNCHES`` by
instance.
"""

from __future__ import annotations

import ctypes

import torch

from ..models.quant import QuantizedBase, QuantizedLinear, QuantizedLinear4
from . import cuda_build

SOURCE = "quant_matmul.cu"
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# The kernel's instances, by their code in csrc/quant_matmul.cu.
INSTANCES = {"f32": 0, "m16": 1, "m64": 2, "m128": 3, "r16": 4}
M128_ROWS = 128     # rows of x per block of the m128 instance
M16_ROWS = 16       # rows of x per block of the m16 instance
STAGE_ROWS = 64     # contraction rows per stage of m128 and m16
# The m16 instance's split of the contraction axis: enough blocks for
# M16_WAVES waves at M16_BLOCKS_PER_SM blocks an SM, no split shorter than
# M16_MIN_STAGES stages.
M16_BLOCKS_PER_SM = 3
M16_WAVES = 2
M16_MIN_STAGES = 4

LAUNCHES: dict[str, int] = {
    "quant_matmul_int8": 0,
    "quant_matmul_int4": 0,
}
INSTANCE_LAUNCHES: dict[str, int] = {f"quant_matmul_{name}": 0 for name in INSTANCES}
_workspaces: dict[tuple[torch.device, int, int], torch.Tensor] = {}


def reset_launch_counts() -> None:
    for counts in (LAUNCHES, INSTANCE_LAUNCHES):
        for name in counts:
            counts[name] = 0


def _bind(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.opsagent_quant_matmul.argtypes = [p] * 4 + [i] * 9 + [p] * 2
    lib.opsagent_quant_matmul.restype = i


def plan(T: int, In: int, Out: int, bits: int, group: int, dtype: torch.dtype,
         sms: int) -> tuple[str, int]:
    """(instance, block columns) of one call, from shapes alone.

    f32 x takes ``f32``. bf16 x takes a staged instance, ``m16`` for
    T <= 16 and ``m128`` above, when In % 8 == 0 and Out % 16 == 0 (every
    16-byte copy aligned) and, for int4, the scale ``group`` is even and
    >= 16 (a packed byte's two rows share a scale row; a stage touches at
    most five); any other shape takes ``r16`` or ``m64``. The staged
    instances' blocks are 128 columns wide, or 64 where 128-wide blocks
    would leave more than half of the ``sms`` SMs without one."""
    if dtype == torch.float32:
        return "f32", 64
    if In % 8 or Out % 16 or (bits == 4 and (group % 2 or group < 16)):
        return ("r16" if T <= 16 else "m64"), 64
    rows = M16_ROWS if T <= 16 else M128_ROWS
    blocks = -(-T // rows) * -(-Out // 128)
    return ("m16" if T <= 16 else "m128"), 128 if 2 * blocks >= sms else 64


def split_k(T: int, In: int, Out: int, block_n: int, sms: int) -> int:
    """Splits of the contraction axis of one ``m16`` call, from shapes
    alone: enough blocks for ``M16_WAVES`` waves at ``M16_BLOCKS_PER_SM``
    blocks an SM, and no split shorter than ``M16_MIN_STAGES`` stages (the
    kernel shares the stages out evenly); 1 where the column tiles fill
    the card (the lm_head) or the axis is short."""
    tiles = -(-T // M16_ROWS) * -(-Out // block_n)
    want = M16_WAVES * M16_BLOCKS_PER_SM * sms // tiles
    return max(1, min(want, -(-In // STAGE_ROWS) // M16_MIN_STAGES))


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
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    instance, block_n = plan(T, In, Out, _bits(w), _group(w), x.dtype, sms)
    splits = split_k(T, In, Out, block_n, sms) if instance == "m16" else 1
    return _launch(x, w, instance, block_n, splits)


def _bits(w: QuantizedBase) -> int:
    return 4 if isinstance(w, QuantizedLinear4) else 8


def _group(w: QuantizedBase) -> int:
    return w.group if isinstance(w, QuantizedLinear4) else w.shape[0]


def _workspace(device: torch.device, partials: int, tiles: int) -> torch.Tensor:
    """The split sums' workspace: ``partials`` floats, then ``tiles`` int32
    counters, zero at creation; every call leaves them zero. Kept per
    layout, so that a call of fixed shapes always gets the same one."""
    key = (device, partials, tiles)
    ws = _workspaces.get(key)
    if ws is None:
        ws = torch.zeros(partials + tiles, dtype=torch.float32, device=device)
        _workspaces[key] = ws
    return ws


def _launch(x: torch.Tensor, w: QuantizedBase, instance: str, block_n: int,
            splits: int = 1) -> torch.Tensor:
    """One launch of ``instance`` on checked inputs."""
    T, In = x.shape
    Out = w.shape[1]
    bits = _bits(w)
    y = torch.empty((T, Out), dtype=x.dtype, device=x.device)
    ws = None
    if splits > 1:  # m16 only
        ws = _workspace(x.device, splits * T * Out, -(-T // M16_ROWS) * -(-Out // block_n))
    rc = cuda_build.library(SOURCE, _bind).opsagent_quant_matmul(
        cuda_build.ptr(x), cuda_build.ptr(w.q), cuda_build.ptr(w.scale),
        cuda_build.ptr(y), T, In, Out, bits, _group(w), _DTYPE_CODES[x.dtype],
        INSTANCES[instance], block_n, splits, cuda_build.ptr(ws),
        cuda_build.stream(x.device),
    )
    name = f"quant_matmul_int{bits}"
    cuda_build.raise_on(rc, f"{name} ({instance})")
    LAUNCHES[name] += 1
    INSTANCE_LAUNCHES[f"quant_matmul_{instance}"] += 1
    return y


def quant_matmul_tp(
    x: torch.Tensor,            # [T, In] the whole input, on every rank
    w: QuantizedBase,           # this rank's columns: [In, Out/tp]
    plain: bool = False,
) -> torch.Tensor:
    """JAX's ``quant_matmul_pallas_tp``, the column-parallel form, under
    SPMD: ``w`` holds this rank's output columns (its scales with them),
    ``x`` is whole, and each rank's kernel call emits its own output
    columns [T, Out/tp]; no collective. Checks the shard contract (x's
    contraction axis whole; an int4 weight's scale groups whole over it);
    ``quant_matmul_cuda`` raises on a shape the kernel does not take."""
    In = w.shape[-2]
    if x.shape[-1] != In:
        raise ValueError(f"x In={x.shape[-1]}: a column shard contracts the whole "
                         f"input axis of {In}")
    if isinstance(w, QuantizedLinear4) and In % w.scale.shape[-3]:
        raise ValueError(f"{w.scale.shape[-3]} int4 scale groups split the "
                         f"{In}-row contraction axis unevenly")
    return quant_matmul_cuda(x, w, plain=plain)
