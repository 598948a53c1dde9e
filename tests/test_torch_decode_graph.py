"""The port's block decode step body against the JAX package's
``decode_block``, and the engine's warmup, on the CPU.

``tiny-test`` in f32 with the same weights on both sides (``params_from_jax``),
over f32 or int8 KV pages filled with the same random rows, with f32 or
int8 weights. The JAX side runs its XLA path; the port drives
``decode_step_body`` through ``decode_block`` eagerly, the code that
``serving.decode_graph`` captures on the card. Greedy tokens are exact; f32
pages agree within 1e-6 absolute and 1e-5 relative (with int8 weights the
two sides sum the dequantized products in another order: one entry in
6144 is 1.1e-6 off, 2e-5 relative); int8 pages have scales within 1e-6 relative and
codes that may differ by 1 where an f32 value sits on a rounding boundary,
in under 0.1 % of the entries (``test_torch_quant_model``'s rule).
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opsagent_tpu.models import llama as jllama
from opsagent_tpu.models.config import TINY_TEST as JAX_TINY
from opsagent_tpu.models.quant import quantize_params
from opsagent_tpu.ops.attention import QuantizedPages as JaxQuantizedPages
from opsagent_tpu.serving.decode_loop import decode_block as jax_decode_block
from opsagent_tpu_torch.models.config import TINY_TEST
from opsagent_tpu_torch.models.convert import params_from_jax
from opsagent_tpu_torch.models.llama import Llama
from opsagent_tpu_torch.serving.decode_loop import (
    DecodeState,
    FsmTables,
    decode_block,
    decode_step_body,
)
from opsagent_tpu_torch.serving.engine import Engine, EngineConfig
from opsagent_tpu_torch.serving.sampler import SamplingParams

PAGE, PAGES, MAXP, BLOCK = 4, 24, 6, 6
PAD = 256
# Rows: budget BLOCK, writing up to its last booked page with -1 slots past
# it (and the row that samples EOS mid-block); budget 1; inactive; budget 0;
# a row whose last two writes fall in a -1 slot and are dropped.
AT = np.array([9, 3, 5, 2, 6], np.int32)
BUDGETS = np.array([BLOCK, 1, 3, 0, 4], np.int32)
ACTIVE = np.array([True, True, False, True, True])
TOKENS = np.array([17, 3, 99, 40, 300], np.int64)
TABLE = np.full((5, MAXP), -1, np.int32)
TABLE[0, :4] = [1, 2, 3, 4]
TABLE[1, :1] = [5]
TABLE[2, :2] = [6, 7]
TABLE[3, :1] = [8]
TABLE[4, :2] = [9, 10]


def _pages(rng, kv_quantize):
    """[L, N, P, K, D] K and V as numpy (int8: (codes, scales)). Pages 0 and
    N - 1 stay as a fresh cache holds them (zeros; scale 1): the two
    readers resolve a -1 slot to different empty pages (the JAX gather to
    the previous layer's last page, the port's to the layer's page 0), and
    both must read zeros there."""
    shape = (TINY_TEST.num_layers, PAGES, PAGE, TINY_TEST.num_kv_heads, TINY_TEST.head_dim_)
    out = []
    for _ in range(2):
        if kv_quantize:
            codes = rng.integers(-127, 128, shape).astype(np.int8)
            scale = rng.uniform(0.005, 0.02, shape[:-1]).astype(np.float32)
            codes[:, [0, -1]], scale[:, [0, -1]] = 0, 1.0
            out.append((codes, scale))
        else:
            rows = rng.standard_normal(shape).astype(np.float32)
            rows[:, [0, -1]] = 0.0
            out.append(rows)
    return out


def _jax_cache(pages):
    return {name: (JaxQuantizedPages(jnp.asarray(p[0]), jnp.asarray(p[1]))
                   if isinstance(p, tuple) else jnp.asarray(p))
            for name, p in zip("kv", pages)}


def _port_cache(model, pages, kv_quantize):
    cache = model.make_cache(PAGES, PAGE, kv_quantize)
    for side, p in zip((cache.k, cache.v), pages):
        if kv_quantize:
            side.q.copy_(torch.from_numpy(p[0]))
            side.scale.copy_(torch.from_numpy(p[1]))
        else:
            side.copy_(torch.from_numpy(p))
    return cache


def _port_block(model, cache, eos_id):
    B = len(TOKENS)
    state = DecodeState.empty(B, MAXP, BLOCK, torch.device("cpu"))
    tables = FsmTables.empty(B, TINY_TEST.vocab_size, 1, torch.device("cpu"))
    step = partial(decode_step_body, model, state, cache, torch.Generator(), eos_id,
                   PAD, True, tables=tables)
    with torch.inference_mode():
        out = decode_block(
            state, step, TOKENS, AT, ACTIVE, BUDGETS, TABLE,
            np.zeros(B, np.float32), np.zeros(B, np.int32), np.ones(B, np.float32),
            n_steps=int(BUDGETS.max()),
        )
    return out.numpy()


@pytest.mark.parametrize("kv_quantize", ["", "int8"])
@pytest.mark.parametrize("quantize", ["", "int8"])
def test_step_body_block_matches_jax_decode_block(quantize, kv_quantize):
    params = jllama.init_params(JAX_TINY, jax.random.PRNGKey(0), dtype=jnp.float32)
    if quantize:
        params = quantize_params(params, quantize)
    model = Llama(TINY_TEST, torch.float32, "cpu", seed=None, quantize=quantize)
    model.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, params),
                                          TINY_TEST))
    pages = _pages(np.random.default_rng(1), kv_quantize)

    # Row 0's third token becomes the EOS id, so row 0 stops mid-block.
    free = _port_block(model, _port_cache(model, pages, kv_quantize), eos_id=-1)
    eos = int(free[0, 2])
    assert eos not in free[0, :2] and eos != PAD

    cache = _port_cache(model, pages, kv_quantize)
    got = _port_block(model, cache, eos)
    B = len(TOKENS)
    want, jcache, _ = jax_decode_block(
        params, JAX_TINY, jnp.asarray(TOKENS, jnp.int32), jnp.asarray(AT),
        jnp.asarray(ACTIVE), jnp.asarray(BUDGETS), _jax_cache(pages),
        jnp.asarray(TABLE), jax.random.PRNGKey(1), jnp.zeros(B, jnp.float32),
        jnp.zeros(B, jnp.int32), jnp.ones(B, jnp.float32), jnp.int32(eos),
        jnp.int32(PAD), n_steps=int(BUDGETS.max()), greedy=True, dtype=jnp.float32,
    )
    np.testing.assert_array_equal(got, np.asarray(want))
    assert got[0, 2] == eos and (got[0, 3:] == PAD).all()       # EOS mid-block
    assert (got[1, 1:] == PAD).all() and (got[1, 0] != PAD)      # budget 1
    assert (got[2] == PAD).all() and (got[3] == PAD).all()       # inactive, budget 0
    assert (got[4, :4] != PAD).all() and (got[4, 4:] == PAD).all()  # writes dropped
    for side, jside in ((cache.k, jcache["k"]), (cache.v, jcache["v"])):
        if kv_quantize:
            np.testing.assert_allclose(side.scale.numpy(), np.asarray(jside.scale),
                                       rtol=1e-6, atol=0)
            diff = np.abs(side.q.numpy().astype(np.int32)
                          - np.asarray(jside.q).astype(np.int32))
            assert diff.max() <= 1 and (diff > 0).mean() < 1e-3
        else:
            np.testing.assert_allclose(side.numpy(), np.asarray(jside), rtol=1e-5,
                                       atol=1e-6)


def test_decode_state_load_keeps_its_buffers():
    """A block copies the host's inputs into the buffers the step reads;
    none is rebound, and a block longer than the state raises."""
    state = DecodeState.empty(5, MAXP, BLOCK, torch.device("cpu"))
    ptrs = [t.data_ptr() for t in state.buffers()]
    B = len(TOKENS)
    sampling = (np.full(B, 0.5, np.float32), np.full(B, 3, np.int32),
                np.full(B, 0.9, np.float32))
    state.load(TOKENS, AT, ACTIVE, BUDGETS, TABLE, *sampling)
    assert [t.data_ptr() for t in state.buffers()] == ptrs
    assert state.act.tolist() == [True, True, False, False, True]
    assert state.page_table.tolist() == TABLE.tolist() and int(state.step) == 0
    with pytest.raises(ValueError, match="n_steps"):
        decode_block(state, lambda: None, TOKENS, AT, ACTIVE, BUDGETS, TABLE,
                     *sampling, n_steps=BLOCK + 1)


SHAPE = dict(page_size=4, num_pages=64, max_pages_per_seq=16, max_batch_size=4,
             decode_block=5, seed=0)
PROMPTS = ([257] + list(range(40, 61)), [257, 9, 8, 7, 6, 5])


def _cache_bytes(cache):
    sides = (cache.k, cache.v)
    if cache.quantized:
        return [t.clone() for s in sides for t in (s.q, s.scale)]
    return [s.clone() for s in sides]


def _alloc_state(eng, ids):
    return (eng.alloc.accounting(), eng.alloc.hit_tokens,
            [(eng.alloc.length(i), eng.alloc.page_table_row(i).tolist()) for i in ids])


@pytest.mark.parametrize("kv_quantize", ["", "int8"])
def test_warmup_leaves_cache_and_allocator_and_tokens_unchanged(kv_quantize):
    """Warmup on an engine with two admitted prompts writes nothing into
    the cache's pages (its writes go to the scratch slot), books no page
    and draws nothing from the engine's generator; the next blocks give
    the tokens of an engine that never warmed up, sampled ones included.
    On the CPU every step runs eagerly."""
    model = Llama(TINY_TEST, torch.float32, "cpu", seed=0)
    cfg = EngineConfig(model="tiny-test", dtype=torch.float32, device="cpu",
                       kv_quantize=kv_quantize, **SHAPE)
    sampling = (SamplingParams(max_tokens=12),
                SamplingParams(temperature=0.8, top_k=20, max_tokens=12))
    outs = []
    for warm in (True, False):
        eng = Engine(cfg, model=model)
        ids = [eng.add_request(p, s) for p, s in zip(PROMPTS, sampling)]
        if warm:
            cache, alloc = _cache_bytes(eng.cache), _alloc_state(eng, ids)
            eng.warmup()
            assert all(torch.equal(a, b) for a, b in zip(cache, _cache_bytes(eng.cache)))
            assert _alloc_state(eng, ids) == alloc
        while any(not eng.sequences[i].done for i in ids):
            eng.step_block()
        assert (eng.decode_replays, eng.mixed_replays) == (0, 0)
        assert eng.decode_eager_steps > 0 and eng.mixed_eager_ticks > 0
        outs.append([eng.finish(i) for i in ids])
    assert outs[0] == outs[1]
    assert all(len(t) == 12 for t in outs[0])
