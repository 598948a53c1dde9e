"""Grammar fast-forward in the port, against the JAX package on the CPU.

- Forced tokens, forced runs and the dense run tables of the port's
  ``TokenFSM`` equal JAX's at every DFA state of the ReAct ToolPrompt
  schema and of a ``tool_calls`` envelope (the port's forced
  ``tool_choice`` schema), at V = 512; ``JsonConstraint.forced_run`` over a
  token prefix too; ``FORCED_RUN_CAP`` is JAX's 12.
- The engine: ``tiny-test`` f32 with the JAX engine's weights
  (``params_from_jax``), the JAX ffwd tests' sizes (page_size 4, buckets
  4/8/16, blocks of 4). A ToolPrompt-constrained greedy row gives the JAX
  engine's tokens with the fast-forward off, through the port with it on
  and off, at ``async_depth`` 1 (``ffwd_step`` between drained blocks) and
  2 (``step_mixed_async``), at f32 pages and at int8 KV.
- A run clamped at ``max_tokens`` finishes "length" at exactly
  ``max_tokens``, and a stop string inside a run ("ques" inside the forced
  key "question") finishes "stop", both with JAX's tokens; no page stays
  owned, and at every settled point of the sync drive the booked length is
  the written length.
- The ``opsagent_ffwd_*`` counters move (skipped dispatches = forced tokens
  for one row), and a row behind a plain callable is counted under
  ``opsagent_async_fallbacks_total{reason="ffwd_ineligible"}``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opsagent_tpu.serving import constrained as jc
from opsagent_tpu.serving.engine import Engine as JaxEngine
from opsagent_tpu.serving.engine import EngineConfig as JaxEngineConfig
from opsagent_tpu.serving.sampler import SamplingParams as JaxSamplingParams
from opsagent_tpu.serving.tokenizer import ByteTokenizer as JaxByteTokenizer
from opsagent_tpu_torch import obs as pobs
from opsagent_tpu_torch.models.config import TINY_TEST
from opsagent_tpu_torch.models.convert import params_from_jax
from opsagent_tpu_torch.models.llama import Llama
from opsagent_tpu_torch.serving import constrained as pc
from opsagent_tpu_torch.serving.engine import Engine, EngineConfig
from opsagent_tpu_torch.serving.sampler import SamplingParams
from opsagent_tpu_torch.serving.scheduler import Request, Scheduler
from opsagent_tpu_torch.serving.tokenizer import ByteTokenizer

# tests/test_ffwd.py's engine sizes.
BASE = dict(page_size=4, num_pages=128, max_pages_per_seq=24, max_batch_size=4,
            decode_block=4, mixed_buckets=(4, 8, 16), max_step_tokens=32)
PROMPT = [257, 3, 1, 4]
# The forced tool_choice envelope the port's API compiles at depth 8.
ENVELOPE = {
    "type": "object",
    "properties": {"tool_calls": {
        "type": "array", "minItems": 1,
        "items": {"type": "object", "properties": {"function": {
            "type": "object",
            "properties": {"name": {"enum": ["kubectl"]},
                           "arguments": {"type": "object",
                                         "properties": {"command": {"type": "string"}}}},
        }}},
    }},
}
SCHEMAS = {"toolprompt": (pc.TOOLPROMPT_SCHEMA, 4), "envelope": (ENVELOPE, 8)}


@functools.lru_cache(maxsize=None)
def _fsms(name):
    schema, depth = SCHEMAS[name]
    jt, pt = JaxByteTokenizer(512), ByteTokenizer(512)
    jdfa = jc.compile_regex(jc.schema_to_regex(schema, depth))
    pdfa = pc.compile_regex(pc.schema_to_regex(schema, depth))
    return (jc.TokenFSM(jdfa, [jt.token_bytes(t) for t in range(512)], jt.eos_id),
            pc.TokenFSM(pdfa, [pt.token_bytes(t) for t in range(512)], pt.eos_id))


def test_forced_run_cap_is_jax_default():
    assert pc.FORCED_RUN_CAP == jc.FORCED_RUN_CAP == 12


@pytest.mark.parametrize("name", sorted(SCHEMAS))
def test_forced_tokens_and_runs_equal_jax(name):
    jfsm, pfsm = _fsms(name)
    assert pfsm.dfa.num_states == jfsm.dfa.num_states
    forced = 0
    for s in list(range(pfsm.dfa.num_states)) + [-1]:
        assert pfsm.forced_token(s) == jfsm.forced_token(s), s
        assert pfsm.forced_run(s) == jfsm.forced_run(s), s
        forced += pfsm.forced_token(s) is not None
    assert forced > 0                       # the schema forces something


@pytest.mark.parametrize("name", sorted(SCHEMAS))
def test_forced_run_tables_equal_jax(name):
    jfsm, pfsm = _fsms(name)
    (jt, jl), (pt, pl) = jfsm.forced_run_table(), pfsm.forced_run_table()
    assert pt.dtype == jt.dtype == np.int32 and pl.dtype == jl.dtype == np.int32
    np.testing.assert_array_equal(pt, jt)
    np.testing.assert_array_equal(pl, jl)
    assert pl[0] == 0 and pl.max() <= pc.FORCED_RUN_CAP


def test_json_constraint_forced_run_over_a_prefix():
    jfsm, pfsm = _fsms("toolprompt")
    jcon, pcon = jc.JsonConstraint(jfsm), pc.JsonConstraint(pfsm)
    text = list(b'{"question":"x","thought":"y","action":{"')
    for n in range(len(text) + 1):
        assert pcon.forced_run(text[:n]) == jcon.forced_run(text[:n]), n
    assert pcon.forced_run([]) == [ord("{")]


# -- the engine against the JAX engine ----------------------------------------
@functools.lru_cache(maxsize=None)
def _jax_engine(kv_quantize=""):
    return JaxEngine(JaxEngineConfig(
        model="tiny-test", dtype=jnp.float32, tp=1, prefill_buckets=(8, 16),
        grammar_ffwd=False, async_depth=1, kv_quantize=kv_quantize, **BASE,
    ))


@functools.lru_cache(maxsize=None)
def _model():
    model = Llama(TINY_TEST, torch.float32, "cpu", seed=None)
    params = jax.tree_util.tree_map(np.asarray, _jax_engine().params)
    model.load_state_dict(params_from_jax(params, TINY_TEST))
    return model


@functools.lru_cache(maxsize=None)
def _oracle(max_tokens=24, stop=(), kv_quantize=""):
    """JAX's constrained greedy tokens and finish reason, fast-forward off."""
    eng = _jax_engine(kv_quantize)
    con = jc.json_constraint(eng.tokenizer, jc.TOOLPROMPT_SCHEMA)
    sid = eng.begin_request(PROMPT, JaxSamplingParams(max_tokens=max_tokens, stop=stop),
                            mask_fn=con)
    while not eng.prefill_step(sid):
        pass
    while not eng.sequences[sid].done:
        eng.step_block([sid])
    eng.drain()
    reason = eng.sequences[sid].finish_reason
    return tuple(eng.finish(sid)), reason


def _engine(depth, ffwd, kv_quantize=""):
    return Engine(EngineConfig(model="tiny-test", dtype=torch.float32, device="cpu",
                               async_depth=depth, grammar_ffwd=ffwd,
                               kv_quantize=kv_quantize, **BASE), model=_model())


def _drive_sync(eng, sid, check_pages=False):
    """ffwd_step between drained blocks (tests/test_ffwd.py's drive)."""
    for _ in range(300):
        if eng.sequences[sid].done:
            break
        eng.drain()
        if check_pages:
            s = eng.sequences[sid]
            assert eng.alloc.length(sid) == eng._host_written(s)
        if not eng.ffwd_step([sid]).get(sid) and not eng.sequences[sid].done:
            eng.step_block([sid])
    eng.drain()
    assert eng.sequences[sid].done


def _drive_async(eng, sid):
    for _ in range(300):
        if eng.sequences[sid].done:
            break
        eng.step_mixed_async([sid], {})
    eng.drain()
    assert eng.sequences[sid].done


def _run(depth, ffwd, max_tokens=24, stop=(), kv_quantize="", check_pages=False):
    """(tokens, finish reason, allocator accounting before, after)."""
    eng = _engine(depth, ffwd, kv_quantize)
    con = pc.json_constraint(eng.tokenizer, pc.TOOLPROMPT_SCHEMA)
    acc0 = eng.alloc.accounting()
    sid = eng.add_request(PROMPT, SamplingParams(max_tokens=max_tokens, stop=stop), con)
    (_drive_async if depth > 1 else functools.partial(
        _drive_sync, check_pages=check_pages))(eng, sid)
    reason = eng.sequences[sid].finish_reason
    return tuple(eng.finish(sid)), reason, acc0, eng.alloc.accounting()


def _skipped():
    return pobs.FFWD_SKIPPED_DISPATCHES.value()


@pytest.mark.parametrize("kv_quantize", ["", "int8"])
@pytest.mark.parametrize("depth", [1, 2])
def test_greedy_tokens_equal_with_ffwd_on_and_off_and_jax(depth, kv_quantize):
    want = _oracle(kv_quantize=kv_quantize)
    k0 = _skipped()
    on = _run(depth, True, kv_quantize=kv_quantize)
    assert _skipped() > k0                              # runs were appended
    off = _run(depth, False, kv_quantize=kv_quantize)
    assert on[:2] == off[:2] == want


@pytest.mark.parametrize("cap", [6, 11])
@pytest.mark.parametrize("depth", [1, 2])
def test_run_clamped_at_max_tokens(depth, cap):
    want = _oracle(max_tokens=cap)
    assert want[1] == "length" and len(want[0]) == cap
    got, reason, acc0, acc1 = _run(depth, True, max_tokens=cap)
    assert (got, reason) == want
    assert acc1["owned"] == 0 and acc1["total"] == acc0["total"]


@pytest.mark.parametrize("depth", [1, 2])
def test_stop_string_inside_a_run(depth):
    want = _oracle(stop=("ques",))
    assert want[1] == "stop" and len(want[0]) < len(_oracle()[0])   # the stop bites
    got, reason, acc0, acc1 = _run(depth, True, stop=("ques",))
    assert (got, reason) == want
    assert acc1["owned"] == 0 and acc1["total"] == acc0["total"] == BASE["num_pages"]


def test_free_pages_after_a_batch_equal_free_pages_before():
    """The sync drive holds booked == written at every settled point; after
    the batch no page is owned and free + trie pages are every page."""
    got, _, acc0, acc1 = _run(1, True, check_pages=True)
    assert got == _oracle()[0]
    assert acc1["owned"] == 0 and acc1["free"] + acc1["trie"] == acc1["total"]
    assert acc0["free"] == acc0["total"]


def test_counters_move_and_one_row_skips_its_forced_tokens():
    k0, t0, r0 = _skipped(), pobs.FFWD_TOKENS.value(), pobs.FFWD_RUNS.value()
    eng = _engine(1, True)
    con = pc.json_constraint(eng.tokenizer, pc.TOOLPROMPT_SCHEMA)
    sid = eng.add_request(PROMPT, SamplingParams(max_tokens=24), con)
    _drive_sync(eng, sid)
    eng.finish(sid)
    tokens = pobs.FFWD_TOKENS.value() - t0
    assert tokens > 0 and pobs.FFWD_RUNS.value() > r0
    assert _skipped() - k0 == tokens == eng.ffwd_tokens
    assert eng.ffwd_dispatches > 0
    assert pobs.DECODE_DISPATCHES.value(kind="ffwd") >= eng.ffwd_dispatches


def test_hosted_rows_count_as_ffwd_ineligible():
    """A plain callable has no device tables: it cannot fast-forward, is
    counted once under ffwd_ineligible, and decodes as the unconstrained
    row (the mask allows everything)."""
    want = _engine(1, False).generate([PROMPT], SamplingParams(max_tokens=6))[0]
    eng = _engine(2, True)

    def mask_all(generated):
        return np.ones((eng.model_cfg.vocab_size,), bool)

    f0 = pobs.ASYNC_FALLBACKS.value(reason="ffwd_ineligible")
    k0 = _skipped()
    sched = Scheduler(eng)
    sched.start()
    try:
        r = sched.submit(Request(PROMPT, SamplingParams(max_tokens=6), mask_fn=mask_all))
        assert r.done.wait(180)
    finally:
        sched.stop()
    assert not r.error and r.tokens == want
    assert pobs.ASYNC_FALLBACKS.value(reason="ffwd_ineligible") == f0 + 1
    assert _skipped() == k0
