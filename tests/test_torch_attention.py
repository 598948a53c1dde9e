"""The port's paged attention against the JAX package's, on the CPU.

Same numpy inputs (seeded) through the JAX oracles, the JAX Pallas kernels
in interpret mode, and the port's plain versions and kernel wrappers (which
take the plain versions for CPU tensors). f32 at 1e-5, the reference's own
tolerance (opsagent_tpu/ops/attention.py:620). Rows the JAX side leaves as
garbage (s >= q_len, length 0) are compared only on the port's side, where
they must be exact zeros.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opsagent_tpu.ops import attention as jattn
from opsagent_tpu.ops.paged_attention_pallas import (
    paged_decode_attention_pallas_dma,
    paged_ragged_attention_pallas_dma,
)
from opsagent_tpu_torch.models.config import TINY_TEST
from opsagent_tpu_torch.models.llama import PagedKVCache
from opsagent_tpu_torch.ops import attention as tattn
from opsagent_tpu_torch.ops.paged_attention import (
    paged_decode_attention_cuda,
    paged_ragged_attention_cuda,
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
