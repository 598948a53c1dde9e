"""The port's async mixed ticks and pipelined blocks, against the JAX package
on the CPU.

``tiny-test`` f32 with the JAX engine's weights (``params_from_jax``), the
JAX async tests' sizes (page_size 4, buckets 4/8/16, blocks of 4), greedy.

- ``async_depth`` 2 gives the tokens of depth 1 and of the JAX engine for
  plain rows through the scheduler (a multi-chunk prompt among them), a
  ToolPrompt row on the device FSM tables beside a plain multi-chunk
  prompt, a stop-string row (its overshoot token discarded), and a decode
  lane riding the admission of another prompt (the lane advances during
  the admission; a commit overlaps a newer tick).
- A row behind a plain callable never rides the async lane: no async
  commit, a "hosted" fallback, the unconstrained tokens.
- ``pipeline_depth`` 2 gives the tokens of depth 0 and of the JAX engine in
  block decode, with an EOS mid-block (the tokenizer's EOS set to a token
  the free run emits in its second block), and blocks enqueued ahead.
- No page leaks after an overshoot rollback: the stop string is derived
  from the free run, and the derivation must find one (the JAX package's
  ``test_async_stop_string_overshoot_discarded_no_page_leak`` finds none on
  its prompt; the first of two prompts here is that one).
- The carry forms of the step bodies against JAX's, two chained calls
  each over the same random pages: ``mixed_step_body`` with ``use_carry``
  against ``mixed_step_carry`` (ToolPrompt tables; tokens of the rows that
  emit, every row's FSM row, the cache), and ``decode_block`` with
  ``override`` against ``decode_block_carry`` (an EOS carried into the
  second block, a lane seated afresh, a lane no longer alive).
"""

import functools
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opsagent_tpu.serving import constrained as jc
from opsagent_tpu.serving.decode_loop import decode_block_carry as jax_decode_block_carry
from opsagent_tpu.serving.decode_loop import mixed_step_carry as jax_mixed_step_carry
from opsagent_tpu.serving.engine import Engine as JaxEngine
from opsagent_tpu.serving.engine import EngineConfig as JaxEngineConfig
from opsagent_tpu.serving.sampler import SamplingParams as JaxSamplingParams
from opsagent_tpu.serving.scheduler import Request as JaxRequest
from opsagent_tpu.serving.scheduler import Scheduler as JaxScheduler
from opsagent_tpu.serving.tokenizer import ByteTokenizer as JaxByteTokenizer
from opsagent_tpu_torch import obs as pobs
from opsagent_tpu_torch.models.config import TINY_TEST
from opsagent_tpu_torch.models.convert import params_from_jax
from opsagent_tpu_torch.models.llama import Llama
from opsagent_tpu_torch.serving import constrained as pc
from opsagent_tpu_torch.serving.decode_loop import (
    DecodeState,
    FsmTables,
    MixedState,
    decode_block,
    decode_step_body,
    mixed_step_body,
)
from opsagent_tpu_torch.serving.engine import Engine, EngineConfig
from opsagent_tpu_torch.serving.sampler import SamplingParams
from opsagent_tpu_torch.serving.scheduler import Request, Scheduler
from opsagent_tpu_torch.serving.tokenizer import ByteTokenizer
from test_torch_decode_graph import PAGE, PAGES, _jax_cache, _pages, _port_cache

BASE = dict(page_size=4, num_pages=128, max_pages_per_seq=24, max_batch_size=4,
            decode_block=4, mixed_buckets=(4, 8, 16), max_step_tokens=32)
PROMPTS = [[257, 9, 8, 7], [257] + list(range(1, 40)), [257, 5, 5, 5, 5, 5]]
BUDGETS = [12, 6, 9]


@functools.lru_cache(maxsize=None)
def _jax_engine():
    return JaxEngine(JaxEngineConfig(model="tiny-test", dtype=jnp.float32, tp=1,
                                     prefill_buckets=(8, 16), async_depth=1, **BASE))


@functools.lru_cache(maxsize=None)
def _model():
    model = Llama(TINY_TEST, torch.float32, "cpu", seed=None)
    params = jax.tree_util.tree_map(np.asarray, _jax_engine().params)
    model.load_state_dict(params_from_jax(params, TINY_TEST))
    return model


@functools.lru_cache(maxsize=None)
def _jax_generate(prompt, max_tokens, stop=()):
    return tuple(_jax_engine().generate(
        [list(prompt)], JaxSamplingParams(max_tokens=max_tokens, stop=stop))[0])


def _engine(**over):
    return Engine(EngineConfig(model="tiny-test", dtype=torch.float32, device="cpu",
                               **{**BASE, **over}), model=_model())


def _serve(eng, requests):
    """Submit ``requests`` to a scheduler over ``eng``; their tokens."""
    sched = Scheduler(eng)
    sched.start()
    try:
        for r in requests:
            sched.submit(r)
        for r in requests:
            assert r.done.wait(180)
            assert not r.error, r.error
    finally:
        sched.stop()
    return [r.tokens for r in requests]


def _commits():
    return pobs.ASYNC_COMMITS.value()


@pytest.mark.parametrize("depth", [1, 2])
def test_plain_rows_through_the_scheduler(depth):
    want = [list(_jax_generate(tuple(p), n)) for p, n in zip(PROMPTS, BUDGETS)]
    c0 = _commits()
    got = _serve(_engine(async_depth=depth),
                 [Request(p, SamplingParams(max_tokens=n)) for p, n in zip(PROMPTS, BUDGETS)])
    assert got == want
    assert (_commits() > c0) == (depth == 2)     # the async lane engaged at 2 only


def test_device_fsm_row_beside_a_multi_chunk_prompt():
    p_con, p_plain = [257, 3, 1, 4], [257] + list(range(1, 30))
    jeng = _jax_engine()
    jsched = JaxScheduler(jeng)
    jsched.start()
    try:
        jrc = jsched.submit(JaxRequest(p_con, JaxSamplingParams(max_tokens=24),
                                       mask_fn=jc.json_constraint(jeng.tokenizer,
                                                                  jc.TOOLPROMPT_SCHEMA)))
        jrp = jsched.submit(JaxRequest(p_plain, JaxSamplingParams(max_tokens=8)))
        assert jrc.done.wait(180) and jrp.done.wait(180)
    finally:
        jsched.stop()
    want = [jrc.tokens, jrp.tokens]
    for depth in (1, 2):
        eng = _engine(async_depth=depth)
        con = pc.json_constraint(eng.tokenizer, pc.TOOLPROMPT_SCHEMA)
        c0 = _commits()
        got = _serve(eng, [Request(p_con, SamplingParams(max_tokens=24), mask_fn=con),
                           Request(p_plain, SamplingParams(max_tokens=8))])
        assert got == want, depth
        assert (_commits() > c0) == (depth == 2)
        assert eng.hosted_steps == 0


def _stop_string(eng, prompts):
    """(prompt, stop text, free run): the first prompt whose free run has a
    token at index >= 2, before the last, whose text is new there (the JAX
    package's first-occurrence derivation)."""
    tok = eng.tokenizer
    for prompt in prompts:
        free = eng.generate([prompt], SamplingParams(max_tokens=12))[0]
        for j in range(2, len(free) - 1):
            t = tok.decode([free[j]])
            if t and t not in tok.decode(free[:j]):
                return prompt, t, free
    return None


def _drive_async(eng, sid):
    for _ in range(100):
        if eng.sequences[sid].done:
            break
        eng.step_mixed_async([sid], {})
    eng.drain()
    assert eng.sequences[sid].done


def test_stop_string_overshoot_discarded_without_a_page_leak():
    sync = _engine(async_depth=1)
    found = _stop_string(sync, [[257, 9, 8, 7], [257, 3, 1, 4]])
    assert found is not None, "no derivable stop string"
    prompt, stop, free = found
    sampling = SamplingParams(max_tokens=12, stop=(stop,))
    want = sync.generate([prompt], sampling)[0]
    assert len(want) < len(free)                        # the stop bites
    assert want == list(_jax_generate(tuple(prompt), 12, (stop,)))
    eng = _engine(async_depth=2)
    acc0 = eng.alloc.accounting()
    o0 = pobs.ASYNC_OVERSHOOT_TOKENS.value()
    sid = eng.add_request(prompt, sampling)
    _drive_async(eng, sid)
    assert eng.sequences[sid].finish_reason == "stop"
    assert eng.finish(sid) == want
    # The tick after the stop's was enqueued when the stop committed.
    assert pobs.ASYNC_OVERSHOOT_TOKENS.value() > o0
    acc1 = eng.alloc.accounting()
    assert acc1["total"] == acc0["total"] == BASE["num_pages"]
    assert acc1["owned"] == 0 and acc0["free"] == acc0["total"]


def test_decode_lane_rides_an_admission_through_lookahead_ticks():
    short, long_prompt = [257, 9, 8, 7], [257] + list(range(1, 40))
    want_short = list(_jax_generate(tuple(short), 12))
    want_long = list(_jax_generate(tuple(long_prompt), 6))
    eng = _engine(async_depth=2)
    ov0 = pobs.ASYNC_OVERLAPPED_COMMITS.value()
    a = eng.add_request(short, SamplingParams(max_tokens=12))
    b = eng.begin_request(long_prompt, SamplingParams(max_tokens=6))
    collected = list(eng.sequences[a].tokens)
    for _ in range(200):
        if b not in eng._prefilling and not eng.async_pending():
            break
        chunks = {}
        if b in eng._prefilling:
            done, total = eng.prefill_progress(b)
            if total > done:
                chunks = {b: min(total - done, 16)}
        lanes = [a] if not eng.sequences[a].done else []
        d_out, _ = eng.step_mixed_async(lanes, chunks)
        collected += d_out.get(a, [])
    assert len(collected) > 1                    # the lane advanced during admission
    while not (eng.sequences[a].done and eng.sequences[b].done):
        eng.step_block([s for s in (a, b) if not eng.sequences[s].done])
    eng.drain()
    assert eng.finish(a) == want_short and eng.finish(b) == want_long
    assert pobs.ASYNC_OVERLAPPED_COMMITS.value() > ov0
    assert eng.async_ticks > 0


def test_hosted_rows_never_ride_the_async_lane():
    prompt = [257, 3, 1, 4, 1, 5]
    want = list(_jax_generate(tuple(prompt), 6))
    eng = _engine(async_depth=2)

    def mask_all(generated):
        return np.ones((eng.model_cfg.vocab_size,), bool)

    c0, f0 = _commits(), pobs.ASYNC_FALLBACKS.value(reason="hosted")
    got = _serve(eng, [Request(prompt, SamplingParams(max_tokens=6), mask_fn=mask_all)])
    assert got == [want]
    assert _commits() == c0 and eng.async_ticks == 0
    assert pobs.ASYNC_FALLBACKS.value(reason="hosted") > f0
    assert eng.hosted_steps > 0


def _eos_tokenizer(cls, eos):
    tok = cls(TINY_TEST.vocab_size)
    tok.eos_id = eos
    return tok


@pytest.mark.parametrize("eos_mid_block", [False, True])
def test_pipelined_blocks_equal_depth_0_and_jax(eos_mid_block):
    prompts = [[257, 60, 61, 62, 63, 64], [257, 3, 1, 4], [257] + list(range(97, 110))]
    sampling = SamplingParams(max_tokens=11)
    tok = jtok = None
    if eos_mid_block:
        # The first prompt's sixth token (the second block's second) made EOS.
        free = _engine(pipeline_depth=0).generate(prompts[:1], sampling)[0]
        eos = free[5]
        assert eos not in free[:5]
        tok = _eos_tokenizer(ByteTokenizer, eos)
        jtok = _eos_tokenizer(JaxByteTokenizer, eos)
    jeng = JaxEngine(JaxEngineConfig(model="tiny-test", dtype=jnp.float32, tp=1,
                                     prefill_buckets=(8, 16), **BASE), tokenizer=jtok)
    want = jeng.generate(prompts, JaxSamplingParams(max_tokens=11))
    outs = {}
    for depth in (0, 2):
        eng = Engine(EngineConfig(model="tiny-test", dtype=torch.float32, device="cpu",
                                  pipeline_depth=depth, **BASE),
                     model=_model(), tokenizer=tok)
        acc0 = eng.alloc.accounting()
        outs[depth] = eng.generate(prompts, sampling)
        assert (eng.pipelined_blocks > 0) == (depth == 2)
        assert not eng._inflight and eng.alloc.accounting()["owned"] == 0
        assert eng.alloc.accounting()["total"] == acc0["total"]
    assert outs[2] == outs[0] == want
    if eos_mid_block:
        assert outs[2][0][-1] == tok.eos_id and len(outs[2][0]) == 6


# -- the carry forms of the step bodies against JAX's --------------------------
# Five rows, each owning four pages (16 positions), pages 0 and 23 empty.
CARRY_TABLE = np.full((5, 6), -1, np.int32)
for _r in range(5):
    CARRY_TABLE[_r, :4] = np.arange(1 + 4 * _r, 5 + 4 * _r)
CACHE_TOL = 1e-5
ZERO_SAMPLING = (np.zeros(5, np.float32), np.zeros(5, np.int32), np.ones(5, np.float32))


def _carry_setup():
    jparams = _jax_engine().params
    pages = _pages(np.random.default_rng(3), "")
    jfsm = jc.json_constraint(JaxByteTokenizer(TINY_TEST.vocab_size), jc.TOOLPROMPT_SCHEMA).fsm
    return jparams, pages, jfsm


def test_mixed_step_carry_matches_jax():
    """Tick 1 from the host (a 3-row chunk that emits, a decode row, an
    inactive row, a chunk that does not finish, a 2-row chunk that
    emits); tick 2 carries the emitting rows' tokens and FSM rows and
    finishes the other chunk from the host."""
    jparams, pages, jfsm = _carry_setup()
    mask, dest = jfsm.dense_tables()
    start = jfsm.dfa.start + 1
    B, S = 5, 4
    ticks = [  # (tokens, starts, q_lens, emits, use_carry, ov_fsm)
        (np.array([[257, 40, 41, 0], [60, 0, 0, 0], [0] * 4, [70, 0, 0, 0], [80, 81, 0, 0]]),
         np.array([9, 3, 0, 2, 6]), np.array([3, 1, 0, 1, 2]),
         np.array([True, True, False, False, True]), np.zeros(5, bool),
         np.array([start, 0, 0, 0, start])),
        (np.array([[0] * 4, [0] * 4, [0] * 4, [71, 72, 0, 0], [0] * 4]),
         np.array([12, 4, 0, 3, 8]), np.array([1, 1, 0, 2, 1]),
         np.array([True, True, False, True, True]),
         np.array([True, True, False, False, True]), np.array([0, 0, 0, start, 0])),
    ]
    model = _model()
    cache = _port_cache(model, pages, "")
    tables = FsmTables.empty(B, TINY_TEST.vocab_size, mask.shape[0], torch.device("cpu"))
    state = MixedState.empty(B, S, CARRY_TABLE.shape[1], torch.device("cpu"))
    jcache = _jax_cache(pages)
    jcarry = jfsm_carry = jnp.zeros(B, jnp.int32)
    fm, fd = jnp.asarray(mask), jnp.asarray(dest)
    with torch.inference_mode():
        tables.load(mask, dest)
        for i, (tokens, starts, qlens, emits, use_carry, ov_fsm) in enumerate(ticks):
            state.load(tokens, starts, qlens, CARRY_TABLE, *ZERO_SAMPLING, ov_fsm, emits,
                       use_carry, carry=state if i else None)
            mixed_step_body(model, state, cache, torch.Generator(), plain=True, tables=tables)
            jout, jcache, jfsm_out = jax_mixed_step_carry(
                jparams, _jax_engine().model_cfg, jnp.asarray(tokens, jnp.int32),
                jnp.asarray(use_carry), jcarry, jnp.asarray(starts, jnp.int32),
                jnp.asarray(qlens, jnp.int32), jnp.asarray(emits), jcache,
                jnp.asarray(CARRY_TABLE), jax.random.PRNGKey(i),
                *(jnp.asarray(a) for a in ZERO_SAMPLING), dtype=jnp.float32,
                fsm_mask=fm, fsm_dest=fd, carry_fsm=jfsm_carry,
                ov_fsm=jnp.asarray(ov_fsm, jnp.int32),
            )
            jcarry, jfsm_carry = jout, jfsm_out
            # JAX's output holds the input token where a row does not emit.
            np.testing.assert_array_equal(state.out.numpy()[emits], np.asarray(jout)[emits])
            np.testing.assert_array_equal(state.fsm.numpy(), np.asarray(jfsm_out))
    fsm_rows = state.fsm.numpy()
    assert fsm_rows[0] > 0 and fsm_rows[3] > 0 and fsm_rows[1] == 0   # constrained / FREE
    # test_torch_model.py's tolerance for the mixed step's cache writes.
    for side, jside in ((cache.k, jcache["k"]), (cache.v, jcache["v"])):
        np.testing.assert_allclose(side.numpy(), np.asarray(jside), rtol=CACHE_TOL,
                                   atol=CACHE_TOL)


def test_decode_block_carry_matches_jax():
    """Block 1 seats every lane from the host, row 0 samples EOS in it;
    block 2 carries lanes 0-2 (row 0 stays retired), seats lane 3 afresh
    and drops lane 4 (not alive)."""
    jparams, pages, jfsm = _carry_setup()
    mask, dest = jfsm.dense_tables()
    B, N = 5, 4
    blocks = [  # (override, tokens, at, alive, budgets, ov_fsm)
        (np.ones(B, bool), np.array([17, 3, 99, 40, 300]), np.array([2, 3, 5, 0, 6]),
         np.array([True, True, True, False, True]), np.array([4, 4, 4, 0, 3]),
         np.array([0, jfsm.dfa.start + 1, 0, 0, 0])),
        (np.array([False, False, False, True, False]), np.array([0, 0, 0, 45, 0]),
         np.array([0, 0, 0, 1, 0]), np.array([True, True, True, True, False]),
         np.array([4, 4, 4, 2, 4]), np.zeros(B, np.int64)),
    ]
    model = _model()

    def port(eos_id):
        cache = _port_cache(model, pages, "")
        state = DecodeState.empty(B, CARRY_TABLE.shape[1], N, torch.device("cpu"))
        tables = FsmTables.empty(B, TINY_TEST.vocab_size, mask.shape[0], torch.device("cpu"))
        step = partial(decode_step_body, model, state, cache, torch.Generator(), eos_id,
                       256, True, tables=tables)
        outs = []
        with torch.inference_mode():
            tables.load(mask, dest)
            for ov, tokens, at, alive, budgets, ov_fsm in blocks:
                outs.append(decode_block(state, step, tokens, at, alive, budgets,
                                         CARRY_TABLE, *ZERO_SAMPLING, n_steps=N,
                                         fsm=ov_fsm, override=ov).numpy().copy())
        return outs, cache

    free, _ = port(-1)
    eos = int(free[0][0, 2])                     # row 0's third token made EOS
    assert eos not in free[0][0, :2]
    got, cache = port(eos)
    jcache = _jax_cache(pages)
    carry = (jnp.zeros(B, jnp.int32), jnp.zeros(B, jnp.int32), jnp.zeros(B, bool),
             jnp.zeros(B, jnp.int32), jax.random.PRNGKey(0))
    for (ov, tokens, at, alive, budgets, ov_fsm), out in zip(blocks, got):
        tok, c_at, c_eos, c_fsm, key = carry
        want, jcache, carry = jax_decode_block_carry(
            jparams, _jax_engine().model_cfg, tok, c_at, c_eos, key, jnp.asarray(ov),
            jnp.asarray(tokens, jnp.int32), jnp.asarray(at, jnp.int32), jnp.asarray(alive),
            jnp.asarray(budgets, jnp.int32), jcache, jnp.asarray(CARRY_TABLE),
            *(jnp.asarray(a) for a in ZERO_SAMPLING), jnp.int32(eos), jnp.int32(256),
            n_steps=N, greedy=True, dtype=jnp.float32, fsm_mask=jnp.asarray(mask),
            fsm_dest=jnp.asarray(dest), carry_fsm=c_fsm,
            ov_fsm=jnp.asarray(ov_fsm, jnp.int32),
        )
        np.testing.assert_array_equal(out, np.asarray(want))
    assert got[0][0, 2] == eos and (got[1][0] == 256).all()    # EOS carried over
    assert (got[1][4] == 256).all() and (got[1][3, :2] != 256).all()
    for side, jside in ((cache.k, jcache["k"]), (cache.v, jcache["v"])):
        np.testing.assert_allclose(side.numpy(), np.asarray(jside), rtol=1e-5, atol=1e-6)
