"""The bf16 latent kernels' plan (and the materialized-MLA ragged kernel's,
the same plan over other tiles), and the plain latent attention at the
shapes that plan cuts, against the JAX package.

The CUDA kernels (``csrc/attention_latent.cuh``) split a latent call's work
on the device: 64-row tiles laid out on one axis, each costing its visible
positions plus ``LATENT_COST`` (``LATENT_EMPTY_COST`` when it sees none),
cut into equal runs, one run a block.
``paged_attention.latent_plan`` mirrors that plan; here it must cover
every visible position of every tile exactly once, give each empty tile
one unit (its zeros), stay inside the table, and keep the partials of the
tiles it cuts within the workspace. The card tests
(``tests/test_torch_kernels_cuda.py``) hold the kernels to the plain
version at the same edges; here the plain version is held to JAX's
``paged_ragged_attention`` / ``paged_decode_attention`` there (f32, 1e-5,
the reference's own tolerance).

The bf16 materialized-MLA ragged kernel (``csrc/attention_mla.cuh``) cuts
its tiles, 64 query rows of one (sequence, kv head), by the same plan
(``mla_lens``). Its split form is written out here in PyTorch: partials of
each block's pieces, merged as the merge kernel folds them, equal the
unsplit plain version.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opsagent_tpu.ops.attention import paged_decode_attention as jax_decode
from opsagent_tpu.ops.attention import paged_ragged_attention as jax_ragged
from opsagent_tpu_torch.ops import attention as tattn
from opsagent_tpu_torch.ops import paged_attention as pa

TOL = 1e-5
H100_SMS = 132

# (S, H, cap, starts, q_lens): the card's timed ragged case, decode rows,
# 64-row tiles that straddle query positions at H = 16 (q_len 1, 3, 5, 77,
# S * H not a multiple of 64), V3's 128 heads.
RAGGED = {
    "timed": (128, 16, 4128, [3968, 0, 5, 1000, 3001, 0, 200, 17],
              [128, 128, 0, 1, 77, 1, 128, 33]),
    "straddle": (77, 16, 2048, [0, 7, 300, 1000], [1, 3, 5, 77]),
    "v3": (5, 128, 512, [0, 9, 400], [5, 0, 3]),
    "one_row": (1, 16, 64, [0], [1]),
}
# (H, cap, lengths): the card's timed decode case, every length 0, one long
# sequence beside empty ones, B = 1, B = 32.
DECODE = {
    "timed": (16, 4128, [0, 1, 16, 255, 256, 257, 2049, 4096]),
    "all_zero": (16, 4096, [0] * 8),
    "long_beside_empty": (16, 8192, [8192, 0, 0, 0, 0]),
    "b1": (16, 256, [255]),
    "b32": (16, 1024, [(37 * i) % 1025 for i in range(32)]),
    "v3": (128, 4128, [0, 1, 2049, 4096]),
}
# (S, H, K, cap, starts, q_lens) of materialized-MLA ragged calls: the
# card's timed rows at V2-Lite's 16 heads (a kv head each), a row longer
# than a block's run beside a decode row, every row at q_len 0, two query
# heads a kv head with a tile that straddles query positions.
MLA = {
    "timed": (128, 16, 16, 4128, [3968, 0, 5, 1000, 3001, 0, 200, 17],
              [128, 128, 0, 1, 77, 1, 128, 33]),
    "long_row": (128, 16, 16, 8192, [8064, 100], [128, 1]),
    "all_empty": (16, 16, 16, 64, [0, 40], [0, 0]),
    "gqa": (40, 4, 2, 1024, [0, 500, 7], [40, 33, 0]),
}
BLOCKS = [1, 7, 132]


def _lens(kind, name):
    if kind == "mla":
        S, H, K, cap, starts, q_lens = MLA[name]
        return pa.mla_lens(S, H, K, cap, starts, q_lens)
    if kind == "ragged":
        S, H, cap, starts, q_lens = RAGGED[name]
        return pa.latent_lens(S, H, cap, start=starts, q_lens=q_lens)
    H, cap, lengths = DECODE[name]
    return pa.latent_lens(1, H, cap, lengths=lengths)


CASES = ([("ragged", n) for n in RAGGED] + [("decode", n) for n in DECODE]
         + [("mla", n) for n in MLA])


@pytest.mark.parametrize("blocks", BLOCKS)
@pytest.mark.parametrize("kind,name", CASES)
def test_plan_covers_every_position_once(kind, name, blocks):
    lens = _lens(kind, name)
    per, runs = pa.latent_plan(lens, blocks)
    assert len(runs) == blocks and per >= pa.LATENT_MIN_RUN
    seen = [np.zeros(n, np.int32) for n in lens]
    zeros = [0] * len(lens)
    for units in runs:
        assert sum(u["hi"] - u["lo"] for u in units) <= per
        for u in units:
            assert 0 <= u["lo"] <= u["hi"] <= lens[u["item"]]
            if lens[u["item"]] == 0:
                zeros[u["item"]] += 1
            seen[u["item"]][u["lo"]:u["hi"]] += 1
    for n, s, z in zip(lens, seen, zeros):
        assert np.all(s == 1) and z == (n == 0)


@pytest.mark.parametrize("blocks", BLOCKS)
@pytest.mark.parametrize("kind,name", CASES)
def test_plan_cuts_write_distinct_slots_in_the_workspace(kind, name, blocks):
    """A tile is cut exactly when more than one block holds its positions;
    each of its pieces has a slot of its own below 2 * blocks, the slot of
    block k's piece 2k + 1 when the tile starts in block k's run, else
    2k (what the merge kernel reads)."""
    lens = _lens(kind, name)
    _, runs = pa.latent_plan(lens, blocks)
    holders: dict[int, list[int]] = {}
    slots = set()
    for k, units in enumerate(runs):
        for u in units:
            holders.setdefault(u["item"], []).append(k)
            if u["cut"]:
                assert u["slot"] in (2 * k, 2 * k + 1) and u["slot"] not in slots
                slots.add(u["slot"])
    for units in runs:
        for u in units:
            ks = holders[u["item"]]
            assert u["cut"] == (len(ks) > 1) and ks == list(range(ks[0], ks[-1] + 1))
    assert all(s < 2 * blocks for s in slots)


@pytest.mark.parametrize("sms", [1, 66, H100_SMS, 1000])
def test_latent_blocks_keep_the_partials_within_the_workspace_budget(sms):
    blocks = pa.latent_blocks(sms)
    assert 1 <= blocks <= sms
    assert pa.latent_workspace_bytes(blocks) <= pa.GRID_WORKSPACE_BYTES


@pytest.mark.parametrize("sms", [1, 66, H100_SMS, 1000])
def test_mla_blocks_keep_the_partials_within_the_workspace_budget(sms):
    blocks = pa.mla_blocks(sms)
    assert 1 <= blocks <= pa.MLA_BLOCKS_PER_SM * sms
    assert pa.mla_workspace_bytes(blocks) <= pa.GRID_WORKSPACE_BYTES


def test_mla_lens_follow_the_tiles_of_each_kv_head():
    """Tile ``((b * K) + kh) * tiles + t`` holds rows (s, g) = divmod(64 t
    + i, G) of kv head kh, and sees up to its last valid row's window."""
    S, H, K, cap, starts, q_lens = MLA["gqa"]
    lens = pa.mla_lens(S, H, K, cap, starts, q_lens)
    G, tiles = H // K, -(-S * (H // K) // pa.LATENT_TILE_ROWS)
    assert len(lens) == len(starts) * K * tiles
    for item, n in enumerate(lens):
        b, t = item // (K * tiles), item % tiles
        last = min(S * G, (t + 1) * pa.LATENT_TILE_ROWS) - 1
        s_last = min(last // G, q_lens[b] - 1)
        first_s = t * pa.LATENT_TILE_ROWS // G
        assert n == (min(starts[b] + s_last + 1, cap) if s_last >= first_s else 0)


def _split_plain(q, k, v, table, start, q_lens, blocks):
    """The materialized-MLA ragged kernel's split form in f32: each block's
    pieces (``latent_plan`` over ``mla_lens``) as the kernel computes them,
    a whole tile normalised, a cut tile's pieces as partials (max, sum,
    accumulators of each row) merged in block order as the merge kernel
    folds them. Rows that see nothing stay zero."""
    B, S, H, D = q.shape
    _, P, K, _ = k.shape
    G, cap = H // K, table.shape[1] * P
    tiles = -(-S * G // pa.LATENT_TILE_ROWS)
    lens = pa.mla_lens(S, H, K, cap, start.tolist(), q_lens.tolist())
    _, runs = pa.latent_plan(lens, blocks)
    t_all = torch.arange(cap)
    rows_of = table.long().clamp(min=0)[:, t_all // P] * P + t_all % P   # [B, cap]
    out = torch.zeros_like(q)
    parts: dict[int, list] = {}
    for units in runs:
        for u in units:
            bk, tile = divmod(u["item"], tiles)
            b, kh = divmod(bk, K)
            r = torch.arange(tile * pa.LATENT_TILE_ROWS,
                             min((tile + 1) * pa.LATENT_TILE_ROWS, S * G))
            s, h = r // G, kh * G + r % G
            lim = torch.where(s < q_lens[b], (start[b] + s + 1).clamp(max=cap), 0)
            t = torch.arange(u["lo"], u["hi"])
            kk = k.reshape(-1, K, D)[rows_of[b, t], kh]
            vv = v.reshape(-1, K, D)[rows_of[b, t], kh]
            sc = (q[b, s, h] @ kk.T) * D ** -0.5
            sc = sc.masked_fill(t[None, :] >= lim[:, None], -torch.inf)
            m = sc.amax(-1, keepdim=True) if len(t) else torch.full((len(r), 1), -torch.inf)
            p = torch.where(torch.isinf(m), 0.0, torch.exp(sc - m))
            piece = (m, p.sum(-1, keepdim=True), p @ vv, b, s, h)
            if u["cut"]:
                parts.setdefault(u["item"], []).append(piece)
            else:
                out[b, s, h] = torch.where(piece[1] > 0, piece[2] / piece[1], 0.0)
    for pieces in parts.values():
        b, s, h = pieces[0][3:]
        mx = torch.stack([pc[0] for pc in pieces]).amax(0)
        w = [torch.where(torch.isinf(mx), 0.0, torch.exp(pc[0] - mx)) for pc in pieces]
        den = sum(wi * pc[1] for wi, pc in zip(w, pieces))
        acc = sum(wi * pc[2] for wi, pc in zip(w, pieces))
        out[b, s, h] = torch.where(den > 0, acc / den, 0.0)
    return out


@pytest.mark.parametrize("blocks", BLOCKS)
@pytest.mark.parametrize("name", sorted(MLA))
def test_mla_partials_merge_to_the_unsplit_plain_version(name, blocks):
    S, H, K, cap, starts, q_lens = MLA[name]
    rng = np.random.default_rng(2)
    B, D, P = len(starts), 192, 16
    owned = [-(-(st + n) // P) for st, n in zip(starts, q_lens)]
    max_pages = cap // P
    N = sum(owned) + 1
    table = np.full((B, max_pages), -1, np.int32)
    free = list(rng.permutation(N))
    for b, n in enumerate(owned):
        table[b, :n] = [free.pop() for _ in range(n)]
    q = _t(rng.standard_normal((B, S, H, D)).astype(np.float32))
    k = _t(rng.standard_normal((N, P, K, D)).astype(np.float32))
    v = _t(rng.standard_normal((N, P, K, D)).astype(np.float32))
    args = (_t(table), _t(np.array(starts, np.int32)), _t(np.array(q_lens, np.int32)))
    got = _split_plain(q, k, v, *args, blocks)
    want = tattn.paged_ragged_attention(q, k, v, *args)
    torch.testing.assert_close(got, want, rtol=TOL, atol=TOL)


def test_plan_spreads_the_timed_ragged_call_over_the_card():
    """The card's timed ragged case: every block of an H100 holds work, no
    block's run passes per, and the partials stay far below the latents
    the run gathers."""
    lens = _lens("ragged", "timed")
    per, runs = pa.latent_plan(lens, H100_SMS)
    assert all(runs)
    for units in runs:
        assert sum(u["hi"] - u["lo"] for u in units) <= per
    cut = sum(u["cut"] for units in runs for u in units)
    partial_bytes = cut * pa.LATENT_TILE_ROWS * (pa.LATENT_DIM + 2) * 4
    gathered = sum(lens) * pa.LATENT_DIM * 2
    assert partial_bytes < gathered / 4


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _pages(rng, B, ctx, P=16):
    owned = [-(-c // P) for c in ctx]
    max_pages = max(max(owned), 1) + 1
    N = sum(owned) + 2
    table = np.full((B, max_pages), -1, np.int32)
    free = list(rng.permutation(N))
    for b, n in enumerate(owned):
        for i in range(n):
            table[b, i] = free.pop()
    pages = rng.standard_normal((N, P, 1, pa.LATENT_DIM)).astype(np.float32)
    return pages, table


@pytest.mark.parametrize("name", sorted(set(RAGGED) - {"timed"}))
def test_plain_latent_ragged_matches_jax_at_tile_edges(name):
    S, H, _, starts, q_lens = RAGGED[name]
    rng = np.random.default_rng(0)
    B = len(starts)
    pages, table = _pages(rng, B, [s + n for s, n in zip(starts, q_lens)])
    q = rng.standard_normal((B, S, H, pa.LATENT_DIM)).astype(np.float32)
    start, ql = np.array(starts, np.int32), np.array(q_lens, np.int32)
    got = tattn.paged_ragged_attention(
        _t(q), _t(pages), _t(pages), _t(table), _t(start), _t(ql)).numpy()
    want = np.asarray(jax_ragged(q, pages, pages, table, start, ql))
    valid = np.arange(S)[None, :] < ql[:, None]
    np.testing.assert_allclose(got[valid], want[valid], rtol=TOL, atol=TOL)
    assert np.all(got[~valid] == 0)


@pytest.mark.parametrize("name", sorted(set(DECODE) - {"timed", "long_beside_empty"}))
def test_plain_latent_decode_matches_jax_at_plan_edges(name):
    H, _, lengths = DECODE[name]
    rng = np.random.default_rng(1)
    B = len(lengths)
    pages, table = _pages(rng, B, lengths)
    q = rng.standard_normal((B, H, pa.LATENT_DIM)).astype(np.float32)
    ln = np.array(lengths, np.int32)
    got = tattn.paged_decode_attention(_t(q), _t(pages), _t(pages), _t(table), _t(ln)).numpy()
    want = np.asarray(jax_decode(q, pages, pages, table, ln, layer=jnp.int32(0)))
    live = ln > 0
    np.testing.assert_allclose(got[live], want[live], rtol=TOL, atol=TOL)
    assert np.all(got[~live] == 0)
