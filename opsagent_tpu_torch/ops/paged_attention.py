"""The paged-attention CUDA kernels: bind, launch, count.

Two hand-written forms for Hopper (``sm_90a``) of the same two functions,
each with instances for pages in q's dtype and for int8 ``QuantizedPages``:

- ``csrc/paged_attention.cu`` (the "dma" backend, the counterparts of the
  JAX package's ``pallas-dma`` kernels): its ragged kernel gives one block
  per (sequence, kv head, query-row tile) the whole sequence;
- ``csrc/paged_attention_grid.cu`` (the "grid" backend, the counterparts
  of its ``pallas`` grid kernels): the page-slot axis becomes a split of
  the KV sequence, partials go to a workspace and a combine pass reduces
  them (with one split the split pass writes the output itself).

Both decode kernels split the KV sequence the same way, over a body they
share (``csrc/attention_split.cuh``), with splits of at most
``DECODE_WALK`` positions. The bf16 instances run tensor-core routines:
the ragged kernels ``csrc/attention_mma.cuh``, the decode kernels
``csrc/attention_decode.cuh``; the f32 instances keep CUDA-core bodies.

``cuda_build`` compiles each source at first use and binds it with
``ctypes``; nothing is compiled when this module is imported.

Each wrapper takes its kernel's plain PyTorch version (``ops/attention.py``;
both forms share it) for CPU tensors, or when the caller passes
``plain=True`` (the explicit way to build a reference on the card). For
CUDA tensors it launches the kernel on the current stream or raises; there
is no fallback. ``LAUNCHES`` counts the kernel launches of each wrapper,
int8-page launches under their own names; a split call (split pass and,
with more than one split, combine) counts once.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import cuda_build
from .attention import QuantizedPages, paged_decode_attention, paged_ragged_attention

SOURCE = "paged_attention.cu"
GRID_SOURCE = "paged_attention_grid.cu"
HEAD_DIMS = (16, 32, 64, 128)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# Query rows per tile of a split pass: the grid ragged kernel's
# (csrc/paged_attention_grid.cu), and both decode kernels' (kDecodeRows in
# csrc/attention_split.cuh).
GRID_TILE_ROWS = {"ragged": 64, "decode": 16}
# The split pass aims at this many blocks per SM ...
GRID_BLOCKS_PER_SM = 2
# ... within this much f32 workspace for the partials; a ragged call also
# takes enough splits that no block walks more than this many positions.
GRID_WORKSPACE_BYTES = 64 << 20
GRID_RAGGED_WALK = 1024
# Both decode kernels take enough splits that no block walks more than this.
DECODE_WALK = 256

LAUNCHES: dict[str, int] = {
    "paged_ragged_attention": 0,
    "paged_decode_attention": 0,
    "paged_ragged_attention_int8": 0,
    "paged_decode_attention_int8": 0,
    "paged_ragged_attention_grid": 0,
    "paged_decode_attention_grid": 0,
    "paged_ragged_attention_grid_int8": 0,
    "paged_decode_attention_grid_int8": 0,
}

# Grid-kernel workspaces, one per (device, size), allocated at the first
# call of that shape and kept. Calls reuse one safely because they run in
# order on the device's current stream, as the engine launches them.
_workspaces: dict[tuple[torch.device, int], torch.Tensor] = {}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _bind(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.opsagent_paged_ragged_attention.argtypes = (
        [p] * 9 + [i] * 7 + [ctypes.c_float, i, p]
    )
    lib.opsagent_paged_ragged_attention.restype = i
    lib.opsagent_paged_decode_attention.argtypes = (
        [p] * 9 + [i] * 8 + [ctypes.c_float, i, p]
    )
    lib.opsagent_paged_decode_attention.restype = i


def _bind_grid(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.opsagent_paged_ragged_attention_grid.argtypes = (
        [p] * 10 + [i] * 9 + [ctypes.c_float, i, p]
    )
    lib.opsagent_paged_ragged_attention_grid.restype = i
    lib.opsagent_paged_decode_attention_grid.argtypes = (
        [p] * 9 + [i] * 8 + [ctypes.c_float, i, p]
    )
    lib.opsagent_paged_decode_attention_grid.restype = i


def _layer_view(pages, layer: int | None):
    """[L, N, P, K, D] + layer -> that layer's contiguous [N, P, K, D] view
    (of both planes for ``QuantizedPages``)."""
    return pages[layer or 0] if pages.ndim == 5 else pages


def _planes(
    pages,
) -> tuple[torch.Tensor, torch.Tensor | None]:
    """(values, scale plane or None)."""
    if isinstance(pages, QuantizedPages):
        return pages.q, pages.scale
    return pages, None


def _check(
    q: torch.Tensor, k_pages, v_pages, ints: dict[str, torch.Tensor], batch: int,
) -> None:
    """Raise on anything the kernels do not take."""
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"q dtype {q.dtype}: the kernels take float32 or bfloat16")
    if isinstance(k_pages, QuantizedPages) != isinstance(v_pages, QuantizedPages):
        raise TypeError("k_pages and v_pages must both be QuantizedPages or neither")
    (kv, ks), (vv, vs) = _planes(k_pages), _planes(v_pages)
    page_dtype = torch.int8 if ks is not None else q.dtype
    for name, t in (("k_pages", kv), ("v_pages", vv)):
        if t.dtype != page_dtype:
            raise TypeError(f"{name} dtype {t.dtype}: expected {page_dtype}")
        if t.ndim != 4 or t.shape != kv.shape:
            raise ValueError(f"{name} shape {tuple(t.shape)}: expected [N, P, K, D]")
    N, P, K, D = kv.shape
    planes = {"k_pages": kv, "v_pages": vv}
    if ks is not None:
        for name, t in (("k_scale", ks), ("v_scale", vs)):
            if t.dtype != torch.float32 or t.shape != (N, P, K):
                raise ValueError(f"{name} {t.dtype} {tuple(t.shape)}: "
                                 f"expected float32 [{N}, {P}, {K}]")
        planes.update(k_scale=ks, v_scale=vs)
    H = q.shape[-2]
    if q.shape[-1] != D or D not in HEAD_DIMS:
        raise ValueError(f"head dim {q.shape[-1]} (pages {D}): expected one of {HEAD_DIMS}")
    if H % K:
        raise ValueError(f"{H} query heads are not a multiple of {K} kv heads")
    floats = {"q": q, **planes}
    for name, t in (*floats.items(), *ints.items()):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, t in floats.items():
        if t.data_ptr() % 16:  # the kernels load rows 16 bytes at a time
            raise ValueError(f"{name} must be 16-byte aligned")
    for name, t in ints.items():
        if t.dtype != torch.int32:
            raise TypeError(f"{name} dtype {t.dtype}: expected int32")
        if t.shape[0] != batch:
            raise ValueError(f"{name} has {t.shape[0]} rows, batch is {batch}")


def _count(name: str, k_scale: torch.Tensor | None) -> None:
    LAUNCHES[name if k_scale is None else f"{name}_int8"] += 1


def paged_ragged_attention_cuda(
    q: torch.Tensor,            # [B, S, H, D]
    k_pages,                    # [N, P, K, D] or [L, N, P, K, D] with layer,
    v_pages,                    # or QuantizedPages of that shape
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
    (kv, ks), (vv, vs) = _planes(k_pages), _planes(v_pages)
    N, P, K, _ = kv.shape
    out = torch.empty_like(q)
    ptr = cuda_build.ptr
    rc = cuda_build.library(SOURCE, _bind).opsagent_paged_ragged_attention(
        ptr(q), ptr(kv), ptr(vv), ptr(ks), ptr(vs), ptr(page_table), ptr(start),
        ptr(q_lens), ptr(out), B, S, H, K, D, P, page_table.shape[1],
        D ** -0.5, _DTYPE_CODES[q.dtype], cuda_build.stream(q.device),
    )
    cuda_build.raise_on(rc, "paged_ragged_attention")
    _count("paged_ragged_attention", ks)
    return out


def paged_decode_attention_cuda(
    q: torch.Tensor,            # [B, H, D]
    k_pages,                    # [N, P, K, D] or [L, N, P, K, D] with layer,
    v_pages,                    # or QuantizedPages of that shape
    page_table: torch.Tensor,   # [B, MaxP] int32
    lengths: torch.Tensor,      # [B] int32, including the new token
    layer: int | None = None,
    plain: bool = False,
) -> torch.Tensor:
    """Paged decode attention (``ops.attention.paged_decode_attention``'s
    contract) through the CUDA kernel, split over the KV sequence."""
    if plain or q.device.type == "cpu":
        return paged_decode_attention(
            q, k_pages, v_pages, page_table, lengths, layer=layer
        )
    k_pages, v_pages = _layer_view(k_pages, layer), _layer_view(v_pages, layer)
    B, H, D = q.shape
    ints = {"page_table": page_table, "lengths": lengths}
    _check(q, k_pages, v_pages, ints, B)
    (kv, ks), (vv, vs) = _planes(k_pages), _planes(v_pages)
    N, P, K, _ = kv.shape
    max_pages = page_table.shape[1]
    splits, span, ws = _grid_plan(q, "decode", 1, K, P, max_pages)
    out = torch.empty_like(q)
    ptr = cuda_build.ptr
    rc = cuda_build.library(SOURCE, _bind).opsagent_paged_decode_attention(
        ptr(q), ptr(kv), ptr(vv), ptr(ks), ptr(vs), ptr(page_table), ptr(lengths),
        ptr(ws), ptr(out), B, H, K, D, P, max_pages, splits, span,
        D ** -0.5, _DTYPE_CODES[q.dtype], cuda_build.stream(q.device),
    )
    cuda_build.raise_on(rc, "paged_decode_attention")
    _count("paged_decode_attention", ks)
    return out


def grid_splits(
    blocks: int, rows: int, D: int, max_pages: int, P: int, sms: int,
    walk: int | None = None,
) -> tuple[int, int]:
    """(splits, span) of a grid call whose split pass has ``blocks`` blocks
    per split over ``rows`` query rows: enough splits for
    ``GRID_BLOCKS_PER_SM`` blocks per SM and, given ``walk``, for no block
    to walk more than ``walk`` of the ``max_pages * P`` positions a row may
    see; no more than ``max_pages`` (a split holds whole pages) nor than
    fit ``GRID_WORKSPACE_BYTES`` of partials (``rows * (D + 2)`` floats per
    split). ``span`` is the cache positions of one split, and no split lies
    wholly past ``max_pages``. Everything comes from shapes: no device
    tensor is read."""
    max_pages = max(max_pages, 1)  # an empty table still takes one split
    want = -(-GRID_BLOCKS_PER_SM * sms // max(blocks, 1))
    if walk is not None:
        want = max(want, -(-max_pages * P // walk))
    fit = GRID_WORKSPACE_BYTES // max(rows * (D + 2) * 4, 1)
    n = max(1, min(want, fit, max_pages))
    pages = -(-max_pages // n)
    return -(-max_pages // pages), pages * P


@functools.cache
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _workspace(device: torch.device, numel: int) -> torch.Tensor:
    ws = _workspaces.get((device, numel))
    if ws is None:
        ws = torch.empty(numel, dtype=torch.float32, device=device)
        _workspaces[(device, numel)] = ws
    return ws


def _grid_plan(
    q: torch.Tensor, form: str, S: int, K: int, P: int, max_pages: int,
) -> tuple[int, int, torch.Tensor | None]:
    """(splits, span, workspace) of one split call (a grid call, or a
    decode call of either form); one split needs no workspace (the split
    pass writes the output and no combine runs)."""
    B, H, D = q.shape[0], q.shape[-2], q.shape[-1]
    tiles = -(-S * (H // K) // GRID_TILE_ROWS[form])
    rows = B * S * H
    sms = _sm_count(q.device)
    walk = GRID_RAGGED_WALK if form == "ragged" else DECODE_WALK
    splits, span = grid_splits(B * K * tiles, rows, D, max_pages, P, sms, walk)
    if splits == 1:
        return splits, span, None
    return splits, span, _workspace(q.device, splits * rows * (D + 2))


def paged_ragged_attention_grid_cuda(
    q: torch.Tensor,            # [B, S, H, D]
    k_pages,                    # [N, P, K, D] or [L, N, P, K, D] with layer,
    v_pages,                    # or QuantizedPages of that shape
    page_table: torch.Tensor,   # [B, MaxP] int32
    start: torch.Tensor,        # [B] int32
    q_lens: torch.Tensor,       # [B] int32
    layer: int | None = None,
    plain: bool = False,
) -> torch.Tensor:
    """Ragged paged attention (``ops.attention.paged_ragged_attention``'s
    contract) through the split-KV grid kernel."""
    if plain or q.device.type == "cpu":
        return paged_ragged_attention(
            q, k_pages, v_pages, page_table, start, q_lens, layer=layer
        )
    k_pages, v_pages = _layer_view(k_pages, layer), _layer_view(v_pages, layer)
    B, S, H, D = q.shape
    ints = {"page_table": page_table, "start": start, "q_lens": q_lens}
    _check(q, k_pages, v_pages, ints, B)
    (kv, ks), (vv, vs) = _planes(k_pages), _planes(v_pages)
    N, P, K, _ = kv.shape
    max_pages = page_table.shape[1]
    splits, span, ws = _grid_plan(q, "ragged", S, K, P, max_pages)
    out = torch.empty_like(q)
    ptr = cuda_build.ptr
    rc = cuda_build.library(GRID_SOURCE, _bind_grid).opsagent_paged_ragged_attention_grid(
        ptr(q), ptr(kv), ptr(vv), ptr(ks), ptr(vs), ptr(page_table), ptr(start),
        ptr(q_lens), ptr(ws), ptr(out), B, S, H, K, D, P, max_pages, splits, span,
        D ** -0.5, _DTYPE_CODES[q.dtype], cuda_build.stream(q.device),
    )
    cuda_build.raise_on(rc, "paged_ragged_attention_grid")
    _count("paged_ragged_attention_grid", ks)
    return out


def paged_decode_attention_grid_cuda(
    q: torch.Tensor,            # [B, H, D]
    k_pages,                    # [N, P, K, D] or [L, N, P, K, D] with layer,
    v_pages,                    # or QuantizedPages of that shape
    page_table: torch.Tensor,   # [B, MaxP] int32
    lengths: torch.Tensor,      # [B] int32, including the new token
    layer: int | None = None,
    plain: bool = False,
) -> torch.Tensor:
    """Paged decode attention (``ops.attention.paged_decode_attention``'s
    contract) through the split-KV grid kernel."""
    if plain or q.device.type == "cpu":
        return paged_decode_attention(
            q, k_pages, v_pages, page_table, lengths, layer=layer
        )
    k_pages, v_pages = _layer_view(k_pages, layer), _layer_view(v_pages, layer)
    B, H, D = q.shape
    ints = {"page_table": page_table, "lengths": lengths}
    _check(q, k_pages, v_pages, ints, B)
    (kv, ks), (vv, vs) = _planes(k_pages), _planes(v_pages)
    N, P, K, _ = kv.shape
    max_pages = page_table.shape[1]
    splits, span, ws = _grid_plan(q, "decode", 1, K, P, max_pages)
    out = torch.empty_like(q)
    ptr = cuda_build.ptr
    rc = cuda_build.library(GRID_SOURCE, _bind_grid).opsagent_paged_decode_attention_grid(
        ptr(q), ptr(kv), ptr(vv), ptr(ks), ptr(vs), ptr(page_table), ptr(lengths),
        ptr(ws), ptr(out), B, H, K, D, P, max_pages, splits, span,
        D ** -0.5, _DTYPE_CODES[q.dtype], cuda_build.stream(q.device),
    )
    cuda_build.raise_on(rc, "paged_decode_attention_grid")
    _count("paged_decode_attention_grid", ks)
    return out


# The attention functions of each paged backend: (ragged, decode).
PAGED_BACKENDS = {
    "dma": (paged_ragged_attention_cuda, paged_decode_attention_cuda),
    "grid": (paged_ragged_attention_grid_cuda, paged_decode_attention_grid_cuda),
}
