"""Attention in plain PyTorch: causal prefill and paged-KV reads and writes.

The port's counterparts of ``opsagent_tpu/ops/attention.py``. The two paged
readers are the plain versions of the CUDA kernels in ``paged_attention.py``:
the CPU runs them, and on the card they are the reference the kernels are
held against. Softmax and both products run in float32 whatever the storage
type, which is the kernels' arithmetic.

Paged layout: pages ``[N, P, K, D]``, or ``[L, N, P, K, D]`` with a
``layer`` index; a sequence owns a row of the page table ``[MaxP]`` of page
ids, -1 meaning unassigned. ``QuantizedPages`` holds int8 pages with one f32
scale per (token, kv head); writes quantize the fresh rows and the readers
dequantize the gathered rows to the query's dtype.

Two deliberate differences from the JAX readers, both on rows the JAX host
discards: a query row with no visible position (``s >= q_len``, or length
0) comes out as exact zeros, and an unassigned (-1) slot reads page 0 of the
layer, as the kernels do.
"""

from __future__ import annotations

import torch

NEG_INF = -1e30


class QuantizedPages:
    """int8 KV pages + per-(slot, token, kv head) f32 scales: ``q`` keeps
    the page layout ``[L, N, P, K, D]`` (or ``[N, P, K, D]``) in int8,
    ``scale`` drops the D axis. One row costs D + 4 bytes against 2 * D in
    bf16. Indexing the leading axis takes a layer's view of both."""

    def __init__(self, q: torch.Tensor, scale: torch.Tensor):
        self.q = q
        self.scale = scale

    def __getitem__(self, i) -> "QuantizedPages":
        return QuantizedPages(self.q[i], self.scale[i])

    @property
    def shape(self) -> torch.Size:
        return self.q.shape

    @property
    def ndim(self) -> int:
        return self.q.ndim

    @property
    def dtype(self) -> torch.dtype:
        return self.q.dtype


def quantize_kv_rows(new: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """[..., K, D] fresh K/V -> (int8 values, [..., K] f32 scales):
    symmetric absmax over the head dim."""
    nf = new.float()
    absmax = nf.abs().amax(dim=-1)
    scale = torch.where(absmax > 0, absmax / 127.0, 1.0)
    q = torch.round(nf / scale[..., None])
    return torch.clamp(q, -127, 127).to(torch.int8), scale


def _dequantize_gathered(
    seq: torch.Tensor, scale: torch.Tensor, dtype: torch.dtype
) -> torch.Tensor:
    """Gathered int8 [..., K, D] + scales [..., K] -> ``dtype``."""
    return (seq.float() * scale[..., None]).to(dtype)


def causal_prefill_attention(
    q: torch.Tensor,        # [B, S, H, D]
    k: torch.Tensor,        # [B, S, K, D]
    v: torch.Tensor,        # [B, S, K, D]
) -> torch.Tensor:
    """Causal grouped-query attention over the fresh K/V (the oracle
    ``forward_full`` uses)."""
    B, S, H, D = q.shape
    K = k.shape[2]
    qg = q.float().reshape(B, S, K, H // K, D) * D ** -0.5
    scores = torch.einsum("bskgd,btkd->bkgst", qg, k.float())
    causal = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
    scores = scores.masked_fill(~causal, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgst,btkd->bskgd", probs, v.float())
    return out.reshape(B, S, H, D).to(q.dtype)


def flat_slot_indices(
    page_table: torch.Tensor,   # [B, MaxP] int page ids (-1 = unassigned)
    start: torch.Tensor,        # [B] write offsets
    S: int,                     # tokens per row being written
    P: int,                     # page size
    total: int,                 # flat pages addressable (N, or L * N)
    base: int = 0,              # layer * N with the layer-axis form
    valid_len: torch.Tensor | None = None,  # [B] valid new tokens per row
) -> torch.Tensor:
    """[B, S] int64 flat cache slot of each written token: token t of row b
    lands at ``(page_table[b, (start+t)//P] + base) * P + (start+t) % P``.
    Unassigned pages and tokens past ``valid_len`` get ``total * P``, one
    past the end: callers drop those rows (``write_pages``) or send them to
    a scratch slot that lies there (``models.llama.PagedKVCache``)."""
    pos = start.long()[:, None] + torch.arange(S, device=start.device)[None, :]
    slot = (pos // P).clamp(0, page_table.shape[1] - 1)
    page = torch.gather(page_table.long(), 1, slot)
    flat = (page + base) * P + pos % P
    keep = page >= 0
    if valid_len is not None:
        t = torch.arange(S, device=start.device)[None, :]
        keep = keep & (t < valid_len.long()[:, None])
    return torch.where(keep, flat, total * P)


def write_pages(
    pages,                      # [N, P, K, D] or [L, N, P, K, D], or QuantizedPages
    new: torch.Tensor,          # [B, S, K, D]
    page_table: torch.Tensor,   # [B, MaxP]
    start: torch.Tensor,        # [B]
    valid_len: torch.Tensor | None = None,
    layer: int | None = None,
):
    """Scatter fresh rows into their pages, in place, and return ``pages``.
    Rows for unassigned pages and padded tokens are masked out before the
    ``index_copy_``: torch has no drop mode for an out-of-range index, and
    a negative one would wrap. ``QuantizedPages`` quantize the rows first
    and write codes and scales at the same flat slots."""
    if isinstance(pages, QuantizedPages):
        q_new, s_new = quantize_kv_rows(new)
        _write_rows(pages.q, q_new, page_table, start, valid_len, layer, 2)
        _write_rows(pages.scale, s_new, page_table, start, valid_len, layer, 1)
        return pages
    _write_rows(pages, new, page_table, start, valid_len, layer, 2)
    return pages


def _write_rows(
    pages: torch.Tensor,        # [(L,) N, P, *row]
    new: torch.Tensor,          # [B, S, *row]
    page_table: torch.Tensor,
    start: torch.Tensor,
    valid_len: torch.Tensor | None,
    layer: int | None,
    row_ndim: int,              # 2 for value pages [K, D], 1 for scales [K]
) -> None:
    lead = pages.shape[: pages.ndim - row_ndim]
    row = pages.shape[pages.ndim - row_ndim:]
    if len(lead) == 3:
        L, N, P = lead
        total, base = L * N, (layer or 0) * N
    else:
        N, P = lead
        total, base = N, 0
    B, S = new.shape[:2]
    flat = flat_slot_indices(
        page_table, start, S, P, total, base, valid_len
    ).reshape(B * S)
    keep = flat < total * P
    pf = pages.view(total * P, *row)
    pf.index_copy_(0, flat[keep], new.reshape(B * S, *row)[keep].to(pages.dtype))


def write_kv_pages(
    k_pages,
    v_pages,
    k_new: torch.Tensor,
    v_new: torch.Tensor,
    page_table: torch.Tensor,
    start: torch.Tensor,
    valid_len: torch.Tensor | None = None,
    layer: int | None = None,
):
    """``write_pages`` for both K and V, in place."""
    write_pages(k_pages, k_new, page_table, start, valid_len, layer)
    write_pages(v_pages, v_new, page_table, start, valid_len, layer)
    return k_pages, v_pages


def _gather_kv(
    k_pages, v_pages, page_table: torch.Tensor, layer: int | None,
    dtype: torch.dtype | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """[B, MaxP] table -> contiguous ([B, T, K, D], [B, T, K, D]) sequence
    views, T = MaxP * P: in the pages' dtype, or for ``QuantizedPages``
    gathered as int8 with their scales and dequantized to ``dtype``."""
    if k_pages.ndim == 5:
        k_pages, v_pages = k_pages[layer or 0], v_pages[layer or 0]
    N, P, K, D = k_pages.shape
    B, max_pages = page_table.shape
    table = page_table.long().clamp(min=0)
    T = max_pages * P
    if isinstance(k_pages, QuantizedPages):
        return tuple(
            _dequantize_gathered(
                pages.q[table].reshape(B, T, K, D),
                pages.scale[table].reshape(B, T, K), dtype,
            )
            for pages in (k_pages, v_pages)
        )
    return (
        k_pages[table].reshape(B, T, K, D),
        v_pages[table].reshape(B, T, K, D),
    )


def paged_ragged_attention(
    q: torch.Tensor,            # [B, S, H, D] queries, right-padded per row
    k_pages,                    # [N, P, K, D] or [L, N, P, K, D] with layer,
    v_pages,                    # or QuantizedPages of that shape
    page_table: torch.Tensor,   # [B, MaxP]
    start: torch.Tensor,        # [B] tokens in cache before this chunk
    q_lens: torch.Tensor,       # [B] valid query rows (0 = inactive row)
    layer: int | None = None,
) -> torch.Tensor:
    """Ragged-query paged attention: query s of row b sees cache positions
    t <= start[b] + s, for s < q_lens[b]; its chunk's K/V is already in the
    pages. Output [B, S, H, D] in q's dtype; rows s >= q_lens[b] are 0."""
    k_seq, v_seq = _gather_kv(k_pages, v_pages, page_table, layer, q.dtype)
    B, S, H, D = q.shape
    T, K = k_seq.shape[1], k_seq.shape[2]
    qg = q.float().reshape(B, S, K, H // K, D) * D ** -0.5
    scores = torch.einsum("bskgd,btkd->bkgst", qg, k_seq.float())
    pos_t = torch.arange(T, device=q.device)[None, None, :]
    s_idx = torch.arange(S, device=q.device)[None, :]
    pos_q = (start.long()[:, None] + s_idx)[:, :, None]                 # [B, S, 1]
    end = (start.long() + q_lens.long())[:, None, None]
    mask = (pos_t <= pos_q) & (pos_t < end)                              # [B, S, T]
    scores = scores.masked_fill(~mask[:, None, None], NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgst,btkd->bskgd", probs, v_seq.float())
    valid = s_idx < q_lens.long()[:, None]                               # [B, S]
    out = torch.where(valid[:, :, None, None], out.reshape(B, S, H, D), 0.0)
    return out.to(q.dtype)


def paged_prefix_attention(
    q: torch.Tensor,            # [B, S, H, D] tail queries, right-padded
    k_pages,                    # [N, P, K, D] or [L, N, P, K, D] with layer,
    v_pages,                    # or QuantizedPages of that shape
    page_table: torch.Tensor,   # [B, MaxP]
    start: torch.Tensor,        # [B] cached-prefix lengths (the tail begins here)
    lengths: torch.Tensor,      # [B] valid tail lengths
    layer: int | None = None,
    backend: str = "dma",
    plain: bool = False,
) -> torch.Tensor:
    """Tail-prefill attention over paged KV holding [prefix + tail], the
    split prefill lane's admission (JAX's ``paged_prefix_attention``, which
    XLA computes): each row's tail queries attend causally over its cached
    prefix pages and the tail written this call. It is the ragged contract
    with ``q_lens = lengths``: on the CPU (or with ``plain``) the plain
    ``paged_ragged_attention``; on a CUDA tensor the ragged kernel of
    ``backend`` (``ops.paged_attention.PAGED_BACKENDS``: the dma kernel, with
    its latent instance for MLA, or the grid kernel), which raises on a shape
    it does not take."""
    if plain or q.device.type == "cpu":
        return paged_ragged_attention(q, k_pages, v_pages, page_table, start, lengths,
                                      layer=layer)
    from .paged_attention import PAGED_BACKENDS

    return PAGED_BACKENDS[backend][0](q, k_pages, v_pages, page_table, start, lengths,
                                      layer=layer)


def paged_decode_attention(
    q: torch.Tensor,            # [B, H, D] one new token per sequence
    k_pages,                    # [N, P, K, D] or [L, N, P, K, D] with layer,
    v_pages,                    # or QuantizedPages of that shape
    page_table: torch.Tensor,   # [B, MaxP]
    lengths: torch.Tensor,      # [B] tokens in cache, including the new one
    layer: int | None = None,
) -> torch.Tensor:
    """One query per sequence over its first ``lengths[b]`` cached tokens.
    Output [B, H, D] in q's dtype; rows with length 0 are 0."""
    k_seq, v_seq = _gather_kv(k_pages, v_pages, page_table, layer, q.dtype)
    B, H, D = q.shape
    T, K = k_seq.shape[1], k_seq.shape[2]
    qg = q.float().reshape(B, K, H // K, D) * D ** -0.5
    scores = torch.einsum("bkgd,btkd->bkgt", qg, k_seq.float())
    valid = torch.arange(T, device=q.device)[None, :] < lengths.long()[:, None]
    scores = scores.masked_fill(~valid[:, None, None], NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgt,btkd->bkgd", probs, v_seq.float())
    out = torch.where((lengths > 0)[:, None, None], out.reshape(B, H, D), 0.0)
    return out.to(q.dtype)
