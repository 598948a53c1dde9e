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

The dma source also holds two more sets of instances of both functions,
for multi-head latent attention (MLA). The materialized ones take head
dims ``MLA_HEAD_DIMS`` (``tiny-mla``'s 24, DeepSeek-V2/V3's 192: per-head
k and v, v zero-padded to the qk head dim as the model writes it) with
pages in q's dtype, and count under ``*_mla``; the ragged function in
bf16 at 192 is a warpgroup kernel of its own (``csrc/attention_mla.cuh``),
split over a fixed grid of ``mla_blocks`` blocks by the latent kernels'
plan (``mla_lens`` and ``latent_plan`` mirror it), counted under
``paged_ragged_attention_mla_wg``. The latent ones are
for pages ``[N, P, 1, 576]`` (DeepSeek-V2/V3's
``kv_lora_rank`` 512 + rope 64) read as both keys and values, which is how
the JAX model calls ``paged_ragged_attention`` and
``paged_decode_attention`` on that path (``csrc/attention_latent.cuh``).
The dma wrappers take that shape only with one kv head and the same pages
as k and v, and count it under ``*_latent``; the grid wrappers do not take
it. In bf16 both functions run one warpgroup kernel over 64-row tiles on
a fixed grid of ``latent_blocks`` blocks, each of which finds its share of
the call's positions on the device (``latent_plan`` mirrors that plan),
and a merge kernel for the tiles cut between blocks.

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
int8-page and materialized-MLA launches under their own names; a split
call (split pass and, with more than one split, combine) counts once.
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
# Materialized MLA's qk head dims (tiny-mla 16 + 8, DeepSeek-V2/V3 128 + 64):
# the dma kernels' instances for pages in q's dtype (an int8 KV cache is
# refused for MLA, as in the JAX engine).
MLA_HEAD_DIMS = (24, 192)
# The bf16 ragged call at this head dim runs the warpgroup kernel
# (csrc/attention_mla.cuh), two blocks an SM.
MLA_WG_DIM = 192
MLA_BLOCKS_PER_SM = 2
# The MLA latent (kv_lora_rank 512 + qk_rope_head_dim 64): the dma kernels'
# latent instances, one kv head, k and v the same pages.
LATENT_DIM = 576
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
# The plan of the warpgroup kernels, the bf16 latent ones and the
# materialized-MLA ragged one (csrc/attention_plan.cuh kPlanTile,
# kPlanCost, kPlanEmptyCost, kPlanMinRun): 64-row tiles, each costing its
# visible positions plus LATENT_COST (LATENT_EMPTY_COST when it sees none:
# it only writes zeros), cut into runs of at least LATENT_MIN_RUN
# positions, one run a block; a cut tile leaves LATENT_TILE_ROWS * (D + 2)
# floats of partials in one of two slots a block.
LATENT_TILE_ROWS = 64
LATENT_COST = 128
LATENT_EMPTY_COST = 32
LATENT_MIN_RUN = 128

LAUNCHES: dict[str, int] = {
    "paged_ragged_attention": 0,
    "paged_decode_attention": 0,
    "paged_ragged_attention_int8": 0,
    "paged_decode_attention_int8": 0,
    "paged_ragged_attention_grid": 0,
    "paged_decode_attention_grid": 0,
    "paged_ragged_attention_grid_int8": 0,
    "paged_decode_attention_grid_int8": 0,
    "paged_ragged_attention_latent": 0,
    "paged_decode_attention_latent": 0,
    "paged_ragged_attention_mla": 0,
    "paged_decode_attention_mla": 0,
    "paged_ragged_attention_mla_wg": 0,
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
    lib.opsagent_paged_ragged_attention_latent.argtypes = (
        [p] * 7 + [i] * 6 + [ctypes.c_float, i, p]
    )
    lib.opsagent_paged_ragged_attention_latent.restype = i
    lib.opsagent_paged_decode_attention_latent.argtypes = (
        [p] * 6 + [i] * 7 + [ctypes.c_float, i, p]
    )
    lib.opsagent_paged_decode_attention_latent.restype = i
    lib.opsagent_paged_ragged_attention_mla.argtypes = [p] * 8 + [i] * 7 + [ctypes.c_float, p]
    lib.opsagent_paged_ragged_attention_mla.restype = i


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
    latent: bool = False,
) -> None:
    """Raise on anything the kernels do not take. ``latent``: the caller
    has the dma kernels' MLA instances: the latent ones, which take head
    dim ``LATENT_DIM`` with one kv head, pages in q's dtype and the same
    pages as k and v, and the materialized ones, which take
    ``MLA_HEAD_DIMS`` with pages in q's dtype."""
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
    if q.shape[-1] == D == LATENT_DIM and latent:
        if K != 1 or ks is not None or kv.data_ptr() != vv.data_ptr():
            raise ValueError(
                f"head dim {LATENT_DIM} is the MLA latent: it takes one kv head, "
                "pages in q's dtype and the same pages as k and v"
            )
    elif q.shape[-1] == D and D in MLA_HEAD_DIMS and latent:
        if ks is not None:
            raise ValueError(f"head dim {D} is materialized MLA: it takes pages in q's "
                             "dtype (no int8 KV cache for MLA)")
    elif q.shape[-1] != D or D not in HEAD_DIMS:
        want = (*HEAD_DIMS, *MLA_HEAD_DIMS, LATENT_DIM) if latent else HEAD_DIMS
        raise ValueError(f"head dim {q.shape[-1]} (pages {D}): expected one of {want}")
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


def _count(name: str, k_scale: torch.Tensor | None, D: int) -> None:
    if D in MLA_HEAD_DIMS:
        name = f"{name}_mla"
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
    _check(q, k_pages, v_pages, ints, B, latent=True)
    (kv, ks), (vv, vs) = _planes(k_pages), _planes(v_pages)
    N, P, K, _ = kv.shape
    out = torch.empty_like(q)
    ptr = cuda_build.ptr
    if D == LATENT_DIM:
        blocks, ws = _latent_workspace(q)
        rc = cuda_build.library(SOURCE, _bind).opsagent_paged_ragged_attention_latent(
            ptr(q), ptr(kv), ptr(page_table), ptr(start), ptr(q_lens), ptr(ws), ptr(out),
            B, S, H, P, page_table.shape[1], blocks, D ** -0.5, _DTYPE_CODES[q.dtype],
            cuda_build.stream(q.device),
        )
        cuda_build.raise_on(rc, "paged_ragged_attention_latent")
        LAUNCHES["paged_ragged_attention_latent"] += 1
        return out
    if D == MLA_WG_DIM and q.dtype == torch.bfloat16:
        blocks, ws = _mla_workspace(q)
        rc = cuda_build.library(SOURCE, _bind).opsagent_paged_ragged_attention_mla(
            ptr(q), ptr(kv), ptr(vv), ptr(page_table), ptr(start), ptr(q_lens), ptr(ws),
            ptr(out), B, S, H, K, P, page_table.shape[1], blocks, D ** -0.5,
            cuda_build.stream(q.device),
        )
        cuda_build.raise_on(rc, "paged_ragged_attention_mla_wg")
        LAUNCHES["paged_ragged_attention_mla_wg"] += 1
        return out
    rc = cuda_build.library(SOURCE, _bind).opsagent_paged_ragged_attention(
        ptr(q), ptr(kv), ptr(vv), ptr(ks), ptr(vs), ptr(page_table), ptr(start),
        ptr(q_lens), ptr(out), B, S, H, K, D, P, page_table.shape[1],
        D ** -0.5, _DTYPE_CODES[q.dtype], cuda_build.stream(q.device),
    )
    cuda_build.raise_on(rc, "paged_ragged_attention")
    _count("paged_ragged_attention", ks, D)
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
    _check(q, k_pages, v_pages, ints, B, latent=True)
    (kv, ks), (vv, vs) = _planes(k_pages), _planes(v_pages)
    N, P, K, _ = kv.shape
    max_pages = page_table.shape[1]
    blocks, ws = _latent_workspace(q) if D == LATENT_DIM else (0, None)
    splits, span = 1, max(max_pages, 1) * P   # taken by split calls only
    if ws is None:
        splits, span, ws = _grid_plan(q, "decode", 1, K, P, max_pages)
    out = torch.empty_like(q)
    ptr = cuda_build.ptr
    if D == LATENT_DIM:
        rc = cuda_build.library(SOURCE, _bind).opsagent_paged_decode_attention_latent(
            ptr(q), ptr(kv), ptr(page_table), ptr(lengths), ptr(ws), ptr(out),
            B, H, P, max_pages, splits, span, blocks, D ** -0.5, _DTYPE_CODES[q.dtype],
            cuda_build.stream(q.device),
        )
        cuda_build.raise_on(rc, "paged_decode_attention_latent")
        LAUNCHES["paged_decode_attention_latent"] += 1
        return out
    rc = cuda_build.library(SOURCE, _bind).opsagent_paged_decode_attention(
        ptr(q), ptr(kv), ptr(vv), ptr(ks), ptr(vs), ptr(page_table), ptr(lengths),
        ptr(ws), ptr(out), B, H, K, D, P, max_pages, splits, span,
        D ** -0.5, _DTYPE_CODES[q.dtype], cuda_build.stream(q.device),
    )
    cuda_build.raise_on(rc, "paged_decode_attention")
    _count("paged_decode_attention", ks, D)
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


def latent_blocks(sms: int) -> int:
    """Blocks of a bf16 latent call: one an SM, within
    ``GRID_WORKSPACE_BYTES`` of partials (two cut tiles a block)."""
    return max(1, min(sms, GRID_WORKSPACE_BYTES // latent_workspace_bytes(1)))


def latent_workspace_bytes(blocks: int) -> int:
    """Two cut tiles' partials a block and its merge task (four int32), the
    layout in ``csrc/attention_latent.cuh`` (``latent_tasks``)."""
    return (2 * blocks * LATENT_TILE_ROWS * (LATENT_DIM + 2) + 4 * blocks) * 4


def _latent_workspace(q: torch.Tensor) -> tuple[int, torch.Tensor | None]:
    """(blocks, workspace) of a latent call: bf16 runs the warpgroup
    kernels; f32 (blocks 0, no workspace) the CUDA-core ones."""
    if q.dtype != torch.bfloat16:
        return 0, None
    blocks = latent_blocks(_sm_count(q.device))
    return blocks, _workspace(q.device, latent_workspace_bytes(blocks) // 4)


def mla_blocks(sms: int) -> int:
    """Blocks of a bf16 materialized-MLA ragged call: ``MLA_BLOCKS_PER_SM``
    an SM, within ``GRID_WORKSPACE_BYTES`` of partials."""
    return max(1, min(MLA_BLOCKS_PER_SM * sms,
                      GRID_WORKSPACE_BYTES // mla_workspace_bytes(1)))


def mla_workspace_bytes(blocks: int) -> int:
    """As ``latent_workspace_bytes`` at head dim ``MLA_WG_DIM``."""
    return (2 * blocks * LATENT_TILE_ROWS * (MLA_WG_DIM + 2) + 4 * blocks) * 4


def _mla_workspace(q: torch.Tensor) -> tuple[int, torch.Tensor]:
    blocks = mla_blocks(_sm_count(q.device))
    return blocks, _workspace(q.device, mla_workspace_bytes(blocks) // 4)


def mla_lens(S: int, H: int, K: int, cap: int, start, q_lens) -> list[int]:
    """The positions each 64-row tile of a materialized-MLA ragged call
    sees (the kernel's ``MlaJob::len``): tiles of the ``S * G`` rows (s, g)
    of each (sequence, kv head), G = H / K, sequence after sequence and kv
    head after kv head."""
    G = H // K
    tiles = -(-S * G // LATENT_TILE_ROWS)
    out = []
    for b in range(len(start)):
        for _ in range(K):
            for tile in range(tiles):
                first = tile * LATENT_TILE_ROWS
                rows = min(LATENT_TILE_ROWS, S * G - first)
                s_last = min((first + rows - 1) // G, int(q_lens[b]) - 1)
                out.append(min(int(start[b]) + s_last + 1, cap) if s_last >= first // G else 0)
    return out


def latent_lens(
    S: int, H: int, cap: int, start=None, q_lens=None, lengths=None,
) -> list[int]:
    """The positions each 64-row tile of a latent call sees, tile after
    tile of each sequence (the kernels' ``LatentJob::len``): ragged rows
    from ``start`` and ``q_lens`` (``mla_lens`` at one kv head), decode (S
    = 1) from ``lengths``."""
    if lengths is None:
        return mla_lens(S, H, 1, cap, start, q_lens)
    tiles = -(-H // LATENT_TILE_ROWS)
    return [min(max(int(n), 0), cap) for n in lengths for _ in range(tiles)]


def latent_plan(lens: list[int], blocks: int) -> tuple[int, list[list[dict]]]:
    """The plan every block of a warpgroup call (bf16 latent, or bf16
    materialized-MLA ragged) computes on the device from its tiles' ``lens``
    (``latent_lens``, ``mla_lens``; csrc/attention_plan.cuh ``plan_run`` /
    ``plan_next``): ``per`` and, for each block, its
    units, each a tile's piece ``[lo, hi)`` of its positions (an empty
    tile: a unit with no positions that writes its zeros), whether the
    tile is cut over blocks, and the partials slot it then writes."""
    costs = [n + (LATENT_COST if n else LATENT_EMPTY_COST) for n in lens]
    total = sum(costs)
    per = max(-(-total // blocks), LATENT_MIN_RUN)
    pres = [sum(costs[:i]) for i in range(len(costs))]
    runs = []
    for k in range(blocks):
        begin, end = k * per, min((k + 1) * per, total)
        units = []
        for item, (n, pre) in enumerate(zip(lens, pres)):
            if pre >= end or pre + costs[item] <= begin:
                continue
            lo, hi = max(begin - pre, 0), min(end - pre, n)
            if lo < hi or (n == 0 and pre >= begin):
                units.append(dict(
                    item=item, lo=lo, hi=max(hi, lo),
                    cut=pre // per != (pre + max(n, 1) - 1) // per,
                    slot=2 * k + (0 if pre < begin else 1),
                ))
        runs.append(units)
    return per, runs


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
    _count("paged_ragged_attention_grid", ks, D)
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
    _count("paged_decode_attention_grid", ks, D)
    return out


# The attention functions of each paged backend: (ragged, decode).
PAGED_BACKENDS = {
    "dma": (paged_ragged_attention_cuda, paged_decode_attention_cuda),
    "grid": (paged_ragged_attention_grid_cuda, paged_decode_attention_grid_cuda),
}


# -- tensor parallelism (JAX's paged_*_attention_pallas_tp) --------------------
def _check_shard(q_heads: int, pages, tp: int, num_heads: int, num_kv_heads: int) -> None:
    """The shard contract of a tensor-parallel call: the model's heads and
    kv heads divide over ``tp``, this rank holds H/tp query heads and
    K/tp kv heads, so each shard keeps the model's G = H/K."""
    if tp < 1 or num_heads % tp or num_kv_heads % tp:
        raise ValueError(f"{num_heads} heads / {num_kv_heads} kv heads do not divide "
                         f"over tp={tp}")
    kv_heads = _planes(pages)[0].shape[-2]
    if q_heads != num_heads // tp or kv_heads != num_kv_heads // tp:
        raise ValueError(
            f"shard holds {q_heads} query and {kv_heads} kv heads: at tp={tp} a shard "
            f"of {num_heads}/{num_kv_heads} heads holds {num_heads // tp}/"
            f"{num_kv_heads // tp}")
    if q_heads // kv_heads != num_heads // num_kv_heads:
        raise ValueError(f"a shard's group {q_heads}/{kv_heads} is not the model's "
                         f"{num_heads}/{num_kv_heads}")


def paged_ragged_attention_tp(
    q: torch.Tensor,            # [B, S, H/tp, D] this rank's query heads
    k_pages,                    # [N, P, K/tp, D] (or [L, ...] with layer)
    v_pages,
    page_table: torch.Tensor,   # [B, MaxP] int32, the same on every rank
    start: torch.Tensor,        # [B] int32
    q_lens: torch.Tensor,       # [B] int32
    *,
    tp: int,
    num_heads: int,
    num_kv_heads: int,
    layer: int | None = None,
    backend: str = "dma",
    plain: bool = False,
) -> torch.Tensor:
    """JAX's ``paged_ragged_attention_pallas_tp`` under SPMD: each rank runs
    the ``backend``'s ragged kernel (``PAGED_BACKENDS``) on its own query
    heads against its own kv heads. The GQA groups stay whole in each
    shard, so no collective is needed (the all-reduce comes at ``wo``).
    Checks the shard contract; the kernel raises on a shape it does not
    take, and a CUDA tensor never takes the plain version unasked."""
    _check_shard(q.shape[-2], k_pages, tp, num_heads, num_kv_heads)
    return PAGED_BACKENDS[backend][0](q, k_pages, v_pages, page_table, start, q_lens,
                                      layer=layer, plain=plain)


def paged_decode_attention_tp(
    q: torch.Tensor,            # [B, H/tp, D] this rank's query heads
    k_pages,                    # [N, P, K/tp, D] (or [L, ...] with layer)
    v_pages,
    page_table: torch.Tensor,   # [B, MaxP] int32, the same on every rank
    lengths: torch.Tensor,      # [B] int32
    *,
    tp: int,
    num_heads: int,
    num_kv_heads: int,
    layer: int | None = None,
    backend: str = "dma",
    plain: bool = False,
) -> torch.Tensor:
    """JAX's ``paged_decode_attention_pallas_tp`` under SPMD: the
    ``backend``'s decode kernel on this rank's heads, as
    ``paged_ragged_attention_tp``."""
    _check_shard(q.shape[-2], k_pages, tp, num_heads, num_kv_heads)
    return PAGED_BACKENDS[backend][1](q, k_pages, v_pages, page_table, lengths,
                                      layer=layer, plain=plain)
