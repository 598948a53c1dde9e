"""The port's paged attention against the JAX package's, on the CPU.

Same numpy inputs (seeded) through the JAX oracles, the JAX Pallas kernels
in interpret mode (the DMA form and the grid form), and the port's plain
versions and kernel wrappers of both backends (which take the plain
versions for CPU tensors). f32 at 1e-5, the reference's own tolerance
(opsagent_tpu/ops/attention.py:620); bf16 at 1e-2 (one bf16 ulp of an
output below 2 is 2^-7); int8 pages at 2e-5 in f32 (the JAX kernels scale
in score space, the port dequantizes rows). Rows the JAX side leaves as
garbage (s >= q_len, length 0) are compared only on the port's side, where
they must be exact zeros.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opsagent_tpu.ops import attention as jattn
from opsagent_tpu.ops.paged_attention_pallas import (
    paged_decode_attention_pallas,
    paged_decode_attention_pallas_dma,
    paged_ragged_attention_pallas,
    paged_ragged_attention_pallas_dma,
)
from opsagent_tpu_torch.models.config import TINY_TEST
from opsagent_tpu_torch.models.llama import PagedKVCache
from opsagent_tpu_torch.ops import attention as tattn
from opsagent_tpu_torch.ops.paged_attention import (
    DECODE_WALK,
    GRID_RAGGED_WALK,
    GRID_TILE_ROWS,
    GRID_WORKSPACE_BYTES,
    grid_splits,
    paged_decode_attention_cuda,
    paged_decode_attention_grid_cuda,
    paged_ragged_attention_cuda,
    paged_ragged_attention_grid_cuda,
)

B, S, H, K, D, P, MAXP, L, N = 3, 8, 4, 2, 16, 4, 6, 2, 20
LAYER = 1
TOL = 1e-5


def _case(seed=0):
    """Row 0 starts mid-page with a full chunk, row 1 is inactive (q_len 0),
    row 2 starts mid-page with 3 rows; -1 slots follow each row's pages."""
    rng = np.random.default_rng(seed)
    start = np.array([5, 0, 9], np.int32)
    q_lens = np.array([8, 0, 3], np.int32)
    table = np.full((B, MAXP), -1, np.int32)
    free = list(rng.permutation(N))
    for b in range(B):
        for i in range(-(-(start[b] + q_lens[b]) // P)):
            table[b, i] = free.pop()
    return dict(
        q=rng.standard_normal((B, S, H, D)).astype(np.float32),
        k=rng.standard_normal((L, N, P, K, D)).astype(np.float32),
        v=rng.standard_normal((L, N, P, K, D)).astype(np.float32),
        table=table, start=start, q_lens=q_lens,
        lengths=(start + q_lens).astype(np.int32),
    )


def _t(c):
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in c.items()}


def _valid_rows(c):
    return np.arange(S)[None, :] < c["q_lens"][:, None]      # [B, S]


@pytest.fixture(scope="module")
def case():
    return _case()


def test_ragged_plain_matches_jax_oracle_and_pallas(case):
    c, t = case, _t(case)
    got = tattn.paged_ragged_attention(
        t["q"], t["k"], t["v"], t["table"], t["start"], t["q_lens"], layer=LAYER
    ).numpy()
    args = (c["q"], c["k"], c["v"], c["table"], c["start"], c["q_lens"])
    oracle = np.asarray(jattn.paged_ragged_attention(*args, layer=jnp.int32(LAYER)))
    pallas = np.asarray(paged_ragged_attention_pallas_dma(
        *args, interpret=True, layer=jnp.int32(LAYER)
    ))
    ok = _valid_rows(c)
    np.testing.assert_allclose(got[ok], oracle[ok], rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got[ok], pallas[ok], rtol=TOL, atol=TOL)
    assert (got[~ok] == 0).all()


def test_decode_plain_matches_jax_oracle_and_pallas(case):
    c, t = case, _t(case)
    q = np.ascontiguousarray(c["q"][:, 0])
    lengths = np.array([13, 0, 12], np.int32)    # includes the new token
    got = tattn.paged_decode_attention(
        torch.from_numpy(q), t["k"], t["v"], t["table"],
        torch.from_numpy(lengths), layer=LAYER,
    ).numpy()
    args = (q, c["k"], c["v"], c["table"], lengths)
    oracle = np.asarray(jattn.paged_decode_attention(*args, layer=jnp.int32(LAYER)))
    pallas = np.asarray(paged_decode_attention_pallas_dma(
        *args, interpret=True, layer=jnp.int32(LAYER)
    ))
    ok = lengths > 0
    np.testing.assert_allclose(got[ok], oracle[ok], rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got[ok], pallas[ok], rtol=TOL, atol=TOL)
    assert (got[~ok] == 0).all()


def test_wrappers_take_plain_version_for_cpu_tensors(case):
    t = _t(case)
    want = tattn.paged_ragged_attention(
        t["q"], t["k"], t["v"], t["table"], t["start"], t["q_lens"], layer=LAYER
    )
    got = paged_ragged_attention_cuda(
        t["q"], t["k"], t["v"], t["table"], t["start"], t["q_lens"], layer=LAYER
    )
    assert torch.equal(got, want)
    q = t["q"][:, 0].contiguous()
    want = tattn.paged_decode_attention(
        q, t["k"][LAYER], t["v"][LAYER], t["table"], t["lengths"]
    )
    got = paged_decode_attention_cuda(
        q, t["k"][LAYER], t["v"][LAYER], t["table"], t["lengths"]
    )
    assert torch.equal(got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_is_ragged_with_one_query(case, dtype):
    """The two kernels share one device function: decode at length n is the
    ragged form at start n - 1, q_len 1."""
    t = _t(case)
    q = t["q"][:, :1].to(dtype)
    k, v = t["k"][LAYER].to(dtype), t["v"][LAYER].to(dtype)
    lengths = t["lengths"]
    ragged = tattn.paged_ragged_attention(
        q, k, v, t["table"], (lengths - 1).clamp(min=0), (lengths > 0).int()
    )
    decode = tattn.paged_decode_attention(q[:, 0], k, v, t["table"], lengths)
    assert torch.equal(ragged[:, 0], decode)


def test_write_kv_pages_matches_jax(case):
    c, t = case, _t(case)
    rng = np.random.default_rng(1)
    k_new = rng.standard_normal((B, S, K, D)).astype(np.float32)
    v_new = rng.standard_normal((B, S, K, D)).astype(np.float32)
    jk, jv = jattn.write_kv_pages(
        jnp.asarray(c["k"]), jnp.asarray(c["v"]), k_new, v_new, c["table"],
        c["start"], valid_len=c["q_lens"], layer=jnp.int32(LAYER),
    )
    tk, tv = t["k"].clone(), t["v"].clone()
    tattn.write_kv_pages(
        tk, tv, torch.from_numpy(k_new), torch.from_numpy(v_new), t["table"],
        t["start"], valid_len=t["q_lens"], layer=LAYER,
    )
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_dropped_rows_write_nothing():
    """An unassigned (-1) page and padded tokens (past valid_len) write
    nothing, through both the masked ``write_pages`` and the cache's
    scratch-slot write."""
    table = torch.tensor([[3, -1], [1, 2]], dtype=torch.int32)
    start = torch.tensor([2, 0], dtype=torch.int32)
    valid = torch.tensor([4, 1], dtype=torch.int32)   # row 0 crosses into -1
    new = torch.arange(1, 2 * 4 * 2 * 16 + 1, dtype=torch.float32).reshape(2, 4, 2, 16)
    pages = torch.zeros(4, 4, 2, 16)
    tattn.write_pages(pages, new, table, start, valid_len=valid)
    assert torch.equal(pages[3, 2:], new[0, :2])       # row 0: slots 2, 3 of page 3
    assert torch.equal(pages[1, 0], new[1, 0])         # row 1: its one valid token
    written = torch.zeros(4, 4, dtype=torch.bool)
    written[3, 2:] = True
    written[1, 0] = True
    assert (pages[~written] == 0).all()

    cache = PagedKVCache(TINY_TEST, 4, 4, torch.float32, torch.device("cpu"))
    flat = tattn.flat_slot_indices(table, start, 4, 4, 4, valid_len=valid)
    cache.write(1, new, new, flat.reshape(-1))
    assert torch.equal(cache.k[1], pages) and torch.equal(cache.v[1], pages)
    assert (cache.k[0] == 0).all()


def test_causal_prefill_matches_jax():
    rng = np.random.default_rng(2)
    q = rng.standard_normal((2, 7, H, D)).astype(np.float32)
    k = rng.standard_normal((2, 7, K, D)).astype(np.float32)
    v = rng.standard_normal((2, 7, K, D)).astype(np.float32)
    want = np.asarray(jattn.causal_prefill_attention(q, k, v))
    got = tattn.causal_prefill_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v)
    ).numpy()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


# -- int8 QuantizedPages ---------------------------------------------------
def _quantized_pages(shape, jax_side):
    """Empty int8 pages [*shape] with scale planes of 1.0, as make_cache
    builds them."""
    if jax_side:
        return jattn.QuantizedPages(
            jnp.zeros(shape, jnp.int8), jnp.ones(shape[:-1], jnp.float32)
        )
    return tattn.QuantizedPages(
        torch.zeros(shape, dtype=torch.int8), torch.ones(shape[:-1])
    )


def test_quantized_write_kv_pages_matches_jax(case):
    """Codes and scales land at the same flat slots, exactly; padded
    tokens and unassigned pages write nothing."""
    c, t = case, _t(case)
    rng = np.random.default_rng(3)
    k_new = rng.standard_normal((B, S, K, D)).astype(np.float32)
    v_new = rng.standard_normal((B, S, K, D)).astype(np.float32) * 4
    shape = (L, N, P, K, D)
    jk, jv = jattn.write_kv_pages(
        _quantized_pages(shape, True), _quantized_pages(shape, True), k_new, v_new,
        c["table"], c["start"], valid_len=c["q_lens"], layer=jnp.int32(LAYER),
    )
    tk, tv = _quantized_pages(shape, False), _quantized_pages(shape, False)
    tattn.write_kv_pages(
        tk, tv, torch.from_numpy(k_new), torch.from_numpy(v_new), t["table"],
        t["start"], valid_len=t["q_lens"], layer=LAYER,
    )
    for got, want in ((tk, jk), (tv, jv)):
        np.testing.assert_array_equal(got.q.numpy(), np.asarray(want.q))
        np.testing.assert_array_equal(got.scale.numpy(), np.asarray(want.scale))
    assert (tk.q[0] == 0).all() and (tk.scale[0] == 1).all()


def _quantized_case(seed, D, B, S, H, K, P, MaxP, N, start, q_lens):
    """Each row's cached prefix and chunk written through the quantized
    write path (per-token absmax scales, as the engine writes them), on
    both sides from the same numpy rows."""
    rng = np.random.default_rng(seed)
    start, q_lens = np.array(start, np.int32), np.array(q_lens, np.int32)
    table = np.full((B, MaxP), -1, np.int32)
    free = list(rng.permutation(N))
    for b in range(B):
        for i in range(-(-(start[b] + q_lens[b]) // P)):
            table[b, i] = free.pop()
    total = int((start + q_lens).max())
    kw = rng.standard_normal((B, total, K, D)).astype(np.float32)
    vw = rng.standard_normal((B, total, K, D)).astype(np.float32)
    zero = np.zeros(B, np.int32)
    jk, jv = jattn.write_kv_pages(
        _quantized_pages((N, P, K, D), True), _quantized_pages((N, P, K, D), True),
        kw, vw, table, zero, valid_len=start + q_lens,
    )
    tk, tv = _quantized_pages((N, P, K, D), False), _quantized_pages((N, P, K, D), False)
    tattn.write_kv_pages(
        tk, tv, torch.from_numpy(kw), torch.from_numpy(vw), torch.from_numpy(table),
        torch.from_numpy(zero), valid_len=torch.from_numpy(start + q_lens),
    )
    q = rng.standard_normal((B, S, H, D)).astype(np.float32)
    return q, (jk, jv), (tk, tv), table, start, q_lens


def test_quantized_ragged_plain_matches_jax_pallas():
    """As tests/test_pallas_paged.py's int8 ragged case, at D = 128: the
    plain reader over int8 pages against the ragged DMA kernel (interpret)
    and the JAX gather reader on the same quantized cache, f32 to 2e-5."""
    B_, S_, H_, K_, D_, P_, MaxP_, N_ = 3, 8, 4, 2, 128, 4, 8, 26
    q, (jk, jv), (tk, tv), table, start, q_lens = _quantized_case(
        23, D_, B_, S_, H_, K_, P_, MaxP_, N_, [9, 0, 4], [1, 8, 0]
    )
    got = tattn.paged_ragged_attention(
        torch.from_numpy(q), tk, tv, torch.from_numpy(table),
        torch.from_numpy(start), torch.from_numpy(q_lens),
    ).numpy()
    pallas = np.asarray(paged_ragged_attention_pallas_dma(
        q, jk, jv, table, start, q_lens, interpret=True
    ))
    oracle = np.asarray(jattn.paged_ragged_attention(q, jk, jv, table, start, q_lens))
    ok = np.arange(S_)[None, :] < q_lens[:, None]
    np.testing.assert_allclose(got[ok], pallas[ok], rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got[ok], oracle[ok], rtol=2e-5, atol=2e-5)
    assert (got[~ok] == 0).all()


def test_quantized_decode_plain_matches_jax_pallas():
    B_, H_, K_, D_, P_, MaxP_, N_ = 3, 8, 2, 128, 4, 8, 26
    lengths = np.array([10, 0, 23], np.int32)
    q, (jk, jv), (tk, tv), table, _, _ = _quantized_case(
        24, D_, B_, 1, H_, K_, P_, MaxP_, N_,
        np.maximum(lengths - 1, 0), (lengths > 0).astype(np.int32),
    )
    q = np.ascontiguousarray(q[:, 0])
    got = tattn.paged_decode_attention(
        torch.from_numpy(q), tk, tv, torch.from_numpy(table), torch.from_numpy(lengths)
    ).numpy()
    pallas = np.asarray(paged_decode_attention_pallas_dma(
        q, jk, jv, table, lengths, interpret=True
    ))
    oracle = np.asarray(jattn.paged_decode_attention(q, jk, jv, table, lengths))
    ok = lengths > 0
    np.testing.assert_allclose(got[ok], pallas[ok], rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got[ok], oracle[ok], rtol=2e-5, atol=2e-5)
    assert (got[~ok] == 0).all()


def test_quantized_wrappers_and_cache_write():
    """The wrappers take the plain version for CPU QuantizedPages, with the
    layer axis; the cache's scratch-slot write gives the same codes and
    scales as the masked write_pages."""
    t = _t(_case(5))
    rng = np.random.default_rng(6)
    new = torch.from_numpy(rng.standard_normal((B, S, K, D)).astype(np.float32))
    cache = PagedKVCache(TINY_TEST, N, P, torch.float32, torch.device("cpu"), "int8")
    flat = tattn.flat_slot_indices(t["table"], t["start"], S, P, N, valid_len=t["q_lens"])
    cache.write(LAYER, new, new * 2, flat.reshape(-1))
    pages = _quantized_pages((L, N, P, K, D), False)
    tattn.write_pages(pages, new, t["table"], t["start"], valid_len=t["q_lens"], layer=LAYER)
    assert torch.equal(cache.k.q, pages.q) and torch.equal(cache.k.scale, pages.scale)
    assert (cache.k.scale[0] == 1).all() and (cache.v.q[0] == 0).all()
    args = (t["q"], cache.k, cache.v, t["table"], t["start"], t["q_lens"])
    assert torch.equal(
        paged_ragged_attention_cuda(*args, layer=LAYER),
        tattn.paged_ragged_attention(*args, layer=LAYER),
    )
    q = t["q"][:, 0].contiguous()
    want = tattn.paged_decode_attention(q, cache.v[LAYER], cache.v[LAYER], t["table"], t["lengths"])
    got = paged_decode_attention_cuda(q, cache.v, cache.v, t["table"], t["lengths"], layer=LAYER)
    assert torch.equal(got, want)


# -- grid form: the port's grid wrappers against JAX's grid kernels ---------
def _grid_case(seed, B, S, H, K, D, P, MaxP, N, start, q_lens, dtype, quantized):
    """Pages written through each side's own write path from the same
    numpy rows (quantized: per-token absmax int8, as the engine writes
    them); q in ``dtype``. Returns (jax args, port args)."""
    rng = np.random.default_rng(seed)
    start, q_lens = np.array(start, np.int32), np.array(q_lens, np.int32)
    table = np.full((B, MaxP), -1, np.int32)
    free = list(rng.permutation(N))
    for b in range(B):
        for i in range(min(-(-(start[b] + q_lens[b]) // P), MaxP)):
            table[b, i] = free.pop()
    total = max(int((start + q_lens).max()), 1)
    kw = rng.standard_normal((B, total, K, D)).astype(np.float32)
    vw = rng.standard_normal((B, total, K, D)).astype(np.float32)
    q = rng.standard_normal((B, S, H, D)).astype(np.float32)
    zero, valid = np.zeros(B, np.int32), start + q_lens
    jdt = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}[dtype]
    if quantized:
        jk, jv = (_quantized_pages((N, P, K, D), True) for _ in range(2))
        tk, tv = (_quantized_pages((N, P, K, D), False) for _ in range(2))
    else:
        jk = jv = jnp.zeros((N, P, K, D), jdt)
        tk, tv = (torch.zeros(N, P, K, D, dtype=dtype) for _ in range(2))
    jk, jv = jattn.write_kv_pages(jk, jv, jnp.asarray(kw, jdt), jnp.asarray(vw, jdt),
                                  table, zero, valid_len=valid)
    tattn.write_kv_pages(tk, tv, torch.from_numpy(kw).to(dtype), torch.from_numpy(vw).to(dtype),
                         torch.from_numpy(table), torch.from_numpy(zero),
                         valid_len=torch.from_numpy(valid))
    jax_args = (jnp.asarray(q, jdt), jk, jv, table, start, q_lens)
    port_args = (torch.from_numpy(q).to(dtype), tk, tv, torch.from_numpy(table),
                 torch.from_numpy(start), torch.from_numpy(q_lens))
    return jax_args, port_args


GRID_TOL = {(torch.float32, False): 1e-5, (torch.bfloat16, False): 1e-2,
            (torch.float32, True): 2e-5}


@pytest.mark.parametrize("dtype,quantized", sorted(GRID_TOL, key=str))
@pytest.mark.parametrize("H,K", [(4, 2), (14, 2)])   # G = 2 and G = 7
def test_ragged_grid_matches_jax_grid_kernel(dtype, quantized, H, K):
    """Decode rows (q_len 1) beside chunks that start mid-page, a q_len 0
    row, and a row whose context runs past MaxP * P."""
    B_, S_, D_, P_, MaxP_, N_ = 4, 8, 16, 4, 6, 40
    jargs, targs = _grid_case(7, B_, S_, H, K, D_, P_, MaxP_, N_,
                              [9, 0, 3, 20], [1, 8, 0, 8], dtype, quantized)
    got = paged_ragged_attention_grid_cuda(*targs).float().numpy()
    want = np.asarray(paged_ragged_attention_pallas(*jargs, interpret=True)).astype(np.float32)
    q_lens = targs[5].numpy()
    ok = np.arange(S_)[None, :] < q_lens[:, None]
    tol = GRID_TOL[(dtype, quantized)]
    np.testing.assert_allclose(got[ok], want[ok], rtol=tol, atol=tol)
    assert (got[~ok] == 0).all()


@pytest.mark.parametrize("dtype,quantized", sorted(GRID_TOL, key=str))
@pytest.mark.parametrize("H,K", [(4, 2), (14, 2)])
def test_decode_grid_matches_jax_grid_kernel(dtype, quantized, H, K):
    """Lengths 0, mid-page, a page boundary, and past MaxP * P."""
    B_, D_, P_, MaxP_, N_ = 4, 16, 4, 6, 40
    lengths = np.array([10, 0, 16, 27], np.int32)
    jargs, targs = _grid_case(8, B_, 1, H, K, D_, P_, MaxP_, N_,
                              np.maximum(lengths - 1, 0), (lengths > 0).astype(np.int32),
                              dtype, quantized)
    jq, jk, jv, table = jargs[:4]
    tq, tk, tv, ttable = targs[:4]
    got = paged_decode_attention_grid_cuda(
        tq[:, 0].contiguous(), tk, tv, ttable, torch.from_numpy(lengths)
    ).float().numpy()
    want = np.asarray(paged_decode_attention_pallas(
        jq[:, 0], jk, jv, table, lengths, interpret=True
    )).astype(np.float32)
    ok = lengths > 0
    tol = GRID_TOL[(dtype, quantized)]
    np.testing.assert_allclose(got[ok], want[ok], rtol=tol, atol=tol)
    assert (got[~ok] == 0).all()


def test_grid_wrappers_take_plain_version_with_layer_axis(case):
    t = _t(case)
    args = (t["q"], t["k"], t["v"], t["table"], t["start"], t["q_lens"])
    assert torch.equal(paged_ragged_attention_grid_cuda(*args, layer=LAYER),
                       tattn.paged_ragged_attention(*args, layer=LAYER))
    q = t["q"][:, 0].contiguous()
    dargs = (q, t["k"], t["v"], t["table"], t["lengths"])
    assert torch.equal(paged_decode_attention_grid_cuda(*dargs, layer=LAYER),
                       tattn.paged_decode_attention(*dargs, layer=LAYER))


WALK = GRID_RAGGED_WALK


@pytest.mark.parametrize("blocks,rows,max_pages,walk,want_splits", [
    (8 * 4 * 1, 8 * 28, 320, None, 9),       # Qwen2.5-7B decode at B = 8: split
    # Its full ragged tick at chip_smoke's timed MaxP: enough blocks, but the
    # walk bound asks for 5 splits and the workspace holds 4.
    (8 * 4 * 14, 8 * 128 * 28, 258, WALK, 4),
    (8 * 4 * 14, 8 * 128 * 28, 320, WALK, 4),    # the engine's MaxP, Qwen's rows
    (8 * 8 * 16, 8 * 128 * 32, 320, WALK, 3),    # ... bench-8b's rows
    (8 * 4 * 2, 8 * 16 * 28, 320, WALK, 5),      # a 16-row bucket: the walk bound
    (8 * 4 * 14, 8 * 128 * 28, 40, WALK, 1),     # a short table: one split
    (8, 2 ** 18, 2048, WALK, 1),         # the workspace bound holds one split
    (8, 2 ** 18, 2048, None, 1),
    (8, 2 ** 15, 2048, None, 3),         # ... or three
    (16, 8 * 4, 3, None, 3),             # never more splits than pages
])
def test_grid_splits(blocks, rows, max_pages, walk, want_splits):
    D, P = 128, 16
    splits, span = grid_splits(blocks, rows, D, max_pages, P, sms=132, walk=walk)
    assert splits == want_splits
    assert span % P == 0 and (splits - 1) * span < max_pages * P <= splits * span
    assert splits == 1 or splits * rows * (D + 2) * 4 <= GRID_WORKSPACE_BYTES
    # No block walks past the bound unless one more split would not fit.
    assert (walk is None or span <= walk
            or (splits + 1) * rows * (D + 2) * 4 > GRID_WORKSPACE_BYTES)
    assert GRID_TILE_ROWS == {"ragged": 64, "decode": 16}
    assert grid_splits(blocks, rows, D, 0, P, sms=132, walk=walk) == (1, P)   # an empty table


# Both decode forms at the served shapes, B = 8: one tile of 16 heads per
# (sequence, kv head), so blocks = B * K per split and rows = B * H.
@pytest.mark.parametrize("B,K,H", [(8, 8, 32), (8, 4, 28)])   # bench-8b, Qwen2.5-7B
@pytest.mark.parametrize("max_pages,want", [
    (258, (17, 256)),    # chip_smoke's timed case: spans of DECODE_WALK positions
    (320, (20, 256)),    # the engine's MaxP
    (10, (5, 32)),       # a short table: splits enough for the SMs, whole pages each
    (1, (1, 16)),
    (0, (1, 16)),        # an empty table still takes one split
])
def test_grid_splits_decode(B, K, H, max_pages, want):
    D, P = 128, 16
    tiles = -(-(H // K) // GRID_TILE_ROWS["decode"])
    assert tiles == 1
    splits, span = grid_splits(B * K * tiles, B * H, D, max_pages, P, sms=132,
                               walk=DECODE_WALK)
    assert (splits, span) == want
    assert span % P == 0 and span <= DECODE_WALK
    assert (splits - 1) * span < max(max_pages, 1) * P <= splits * span
    assert splits * B * H * (D + 2) * 4 <= GRID_WORKSPACE_BYTES
