"""The port's constrained decoding against the JAX package's, on the CPU.

- The compiler: ``compile_regex(schema_to_regex(s))`` gives the JAX
  package's DFA (``next``, ``accept``, ``start``) for the ReAct ToolPrompt
  schema, the device-FSM test's schema, the fan-out finding schema and the
  schemaless ``json_object``; the dense device tables are bit-equal for the
  byte tokenizer at V = 512, and for the ToolPrompt schema at the served
  width V = 128,256; host masks agree on 50 seeded states of the
  ``json_object`` DFA (the JAX side through its native matcher where it
  loads).
- The engine: ``tiny-test`` f32 with the JAX engine's weights
  (``params_from_jax``). Greedy constrained tokens through the port equal
  the JAX engine's (``begin_request(mask_fn=...)`` + ``prefill_step`` +
  ``step_block``) for a device-FSM row, for hosted rows (a plain callable,
  and ``json_object`` with the table budget cut so that it is over budget
  at V = 512 as it is at every served vocab), for a constrained row
  admitted in a mixed tick beside an unconstrained decode lane, and for two
  schemas at once (one on the device tables, one hosted). All comparisons
  are exact.
- Sampled rows (temperature 1, top-k 5) never emit a token that their mask
  forbids.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opsagent_tpu.agent.fanout.orchestrator import FINDING_SCHEMA
from opsagent_tpu.serving import constrained as jc
from opsagent_tpu.serving.engine import Engine as JaxEngine
from opsagent_tpu.serving.engine import EngineConfig as JaxEngineConfig
from opsagent_tpu.serving.sampler import SamplingParams as JaxSamplingParams
from opsagent_tpu.serving.tokenizer import ByteTokenizer as JaxByteTokenizer
from opsagent_tpu_torch.models.config import TINY_TEST
from opsagent_tpu_torch.models.convert import params_from_jax
from opsagent_tpu_torch.models.llama import Llama
from opsagent_tpu_torch.serving import constrained as pc
from opsagent_tpu_torch.serving.decode_loop import FsmTables, MixedState, mixed_step_body
from opsagent_tpu_torch.serving.engine import Engine, EngineConfig
from opsagent_tpu_torch.serving.sampler import NEG_INF, SamplingParams, sample
from opsagent_tpu_torch.serving.tokenizer import ByteTokenizer

# tests/test_device_fsm.py's schema.
SCHEMA = {
    "type": "object",
    "properties": {
        "name": {"enum": ["kubectl", "trivy"]},
        "ok": {"type": "boolean"},
    },
}
SCHEMA_X = {"type": "object", "properties": {"x": {"type": "integer"}}}
SCHEMAS = {"toolprompt": pc.TOOLPROMPT_SCHEMA, "device_fsm": SCHEMA,
           "finding": FINDING_SCHEMA, "json_object": None}
# DFA states of the ToolPrompt schema and of json_object (depth 4).
STATES = {"toolprompt": 200, "json_object": 15333}


def _dfas(schema):
    return (jc.compile_regex(jc.schema_to_regex(schema)),
            pc.compile_regex(pc.schema_to_regex(schema)))


@pytest.mark.parametrize("name", list(SCHEMAS))
def test_dfa_equals_jax(name):
    want, got = _dfas(SCHEMAS[name])
    np.testing.assert_array_equal(got.next, want.next)
    np.testing.assert_array_equal(got.accept, want.accept)
    assert got.start == want.start
    if name in STATES:
        assert got.num_states == STATES[name]


def _token_fsms(schema, vocab):
    jdfa, pdfa = _dfas(schema)
    jtok, ptok = JaxByteTokenizer(vocab), ByteTokenizer(vocab)
    return (jc.TokenFSM(jdfa, [jtok.token_bytes(t) for t in range(vocab)], jtok.eos_id),
            pc.TokenFSM(pdfa, [ptok.token_bytes(t) for t in range(vocab)], ptok.eos_id))


@pytest.mark.parametrize("name,vocab", [(n, 512) for n in SCHEMAS]
                         + [("toolprompt", 128_256)])
def test_dense_tables_equal_jax(name, vocab):
    jfsm, pfsm = _token_fsms(SCHEMAS[name], vocab)
    (jmask, jdest), (pmask, pdest) = jfsm.dense_tables(), pfsm.dense_tables()
    assert pmask.dtype == jmask.dtype == bool and pdest.dtype == jdest.dtype == np.int32
    np.testing.assert_array_equal(pmask, jmask)
    np.testing.assert_array_equal(pdest, jdest)
    assert pmask[0].all() and not pdest[0].any()      # the FREE sentinel


def test_host_masks_equal_jax_on_json_object_states():
    jfsm, pfsm = _token_fsms(None, 512)
    states = np.random.default_rng(0).choice(pfsm.dfa.num_states, 50, replace=False)
    for s in states.tolist() + [-1]:
        np.testing.assert_array_equal(pfsm.mask_for_state(s), jfsm.mask_for_state(s))
    for s, tok in zip(states.tolist(), range(40, 90)):
        assert pfsm.advance(s, tok) == jfsm.advance(s, tok)


def test_json_constraint_limits_and_cache():
    tok = ByteTokenizer(512)
    assert (pc.NATIVE_TABLE_BUDGET, pc.MAX_DFA_STATES, pc.FSM_CACHE_CAPACITY) == (
        64_000_000, 100_000, 8)
    a, b = pc.json_constraint(tok, SCHEMA), pc.json_constraint(tok, SCHEMA)
    assert a is not b and a.fsm is b.fsm                       # one FSM per schema
    assert pc.device_table_fsm(a) is a.fsm
    assert pc.device_table_fsm(lambda toks: a(toks)) is None   # a plain callable
    # json_object at the served vocab is over the table budget: hosted.
    assert pc.device_table_fsm(pc.json_constraint(ByteTokenizer(128_256), None)) is None
    for i in range(pc.FSM_CACHE_CAPACITY + 2):
        pc.json_constraint(tok, {"enum": [f"v{i}"]})
    assert len(tok._fsm_cache) == pc.FSM_CACHE_CAPACITY


def test_concurrent_requests_of_one_schema_share_one_fsm():
    """Handler threads that compile one schema at once get one TokenFSM
    (the engine keeps one table set resident, by identity)."""
    import sys
    import threading

    tok = ByteTokenizer(512)
    barrier = threading.Barrier(16)
    got = []

    def ask():
        barrier.wait(timeout=60)
        got.append(pc.json_constraint(tok, pc.TOOLPROMPT_SCHEMA).fsm)

    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=ask) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(switch)
    assert not any(t.is_alive() for t in threads)
    assert len(got) == 16 and all(f is got[0] for f in got)
    assert pc.json_constraint(tok, pc.TOOLPROMPT_SCHEMA).fsm is got[0]


# -- the engine against the JAX engine -----------------------------------------
KW = dict(page_size=8, num_pages=512, max_pages_per_seq=64, max_batch_size=4)
MAX_TOKENS = 48


@pytest.fixture(scope="module")
def engines():
    jeng = JaxEngine(JaxEngineConfig(
        model="tiny-test", dtype=jnp.float32, tp=1, prefill_buckets=(16,), **KW
    ))
    model = Llama(TINY_TEST, torch.float32, "cpu", seed=None)
    model.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, jeng.params),
                                          TINY_TEST))
    cfg = EngineConfig(model="tiny-test", dtype=torch.float32, device="cpu",
                       decode_block=8, seed=0, **KW)
    return jeng, model, cfg


def _jax_run(jeng, prompt, schema=None, host=False):
    """JAX's greedy tokens for one prompt, constrained by ``schema`` (a
    plain-callable wrapper when ``host``)."""
    mask_fn = None
    if schema is not False:
        con = jc.json_constraint(jeng.tokenizer, schema)
        mask_fn = (lambda toks: con(toks)) if host else con
    sid = jeng.begin_request(prompt, JaxSamplingParams(max_tokens=MAX_TOKENS),
                             mask_fn=mask_fn)
    while not jeng.prefill_step(sid):
        pass
    while not jeng.sequences[sid].done:
        jeng.step_block([sid])
    return jeng.finish(sid)


def _live_prefix(fsm, toks):
    st = fsm.dfa.start
    for t in toks:
        if t == fsm.eos_id:
            return fsm.dfa.accept[st]
        st = fsm.advance(st, t)
        if st < 0:
            return False
    return True


def _decode_all(eng, ids):
    while any(not eng.sequences[i].done for i in ids):
        eng.step_block([i for i in ids if not eng.sequences[i].done])
    return [eng.finish(i) for i in ids]


def test_device_fsm_row_matches_jax(engines):
    jeng, model, cfg = engines
    want = _jax_run(jeng, [257, 1, 2, 3], SCHEMA)
    eng = Engine(cfg, model=model)
    con = pc.json_constraint(eng.tokenizer, SCHEMA)
    got = eng.generate([[257, 1, 2, 3]], SamplingParams(max_tokens=MAX_TOKENS),
                       mask_fn=[con])[0]
    assert got == want and _live_prefix(con.fsm, got)
    assert got[-1] == eng.tokenizer.eos_id                # the schema closes
    assert (eng.fsm_loads, eng.hosted_steps) == (1, 0)
    assert eng._fsm_loaded is con.fsm and eng._fsm.rows == con.fsm.dfa.num_states + 1


@pytest.mark.parametrize("kind", ["callable", "json_object"])
def test_hosted_row_matches_jax(engines, monkeypatch, kind):
    """A plain callable, and ``json_object`` with the table budget cut to
    1e6 entries (15,334 x 512 is over it; the ToolPrompt schema's 201 x 512
    is not): both ride the host masks, one step a ``step_block`` call."""
    jeng, model, cfg = engines
    prompt = [257, 4, 5]
    schema = SCHEMA if kind == "callable" else None
    want = _jax_run(jeng, prompt, schema, host=kind == "callable")
    monkeypatch.setattr(pc, "NATIVE_TABLE_BUDGET", 1_000_000)
    eng = Engine(cfg, model=model)
    con = pc.json_constraint(eng.tokenizer, schema)
    mask_fn = (lambda toks: con(toks)) if kind == "callable" else con
    assert pc.device_table_fsm(mask_fn) is None
    sid = eng.add_request(prompt, SamplingParams(max_tokens=MAX_TOKENS), mask_fn)
    calls = 0
    while not eng.sequences[sid].done:
        assert len(eng.step_block([sid])[sid]) == 1
        calls += 1
    got = eng.finish(sid)
    assert got == want and _live_prefix(con.fsm, got)
    assert eng.hosted_steps == calls == len(got) - 1 and eng.fsm_loads == 0


def test_constrained_row_admitted_beside_an_unconstrained_lane(engines):
    """A decodes unconstrained while B's prompt is admitted in mixed ticks
    (A's lane in each), then both block-decode: A's tokens are those of an
    unconstrained run, B's those of JAX's constrained run."""
    jeng, model, cfg = engines
    pa, pb = [257] + list(range(11, 30)), [257, 5, 6] + list(range(60, 80))
    want_a = _jax_run(jeng, pa, schema=False)
    want_b = _jax_run(jeng, pb, SCHEMA)
    eng = Engine(cfg, model=model)
    con = pc.json_constraint(eng.tokenizer, SCHEMA)
    sampling = SamplingParams(max_tokens=MAX_TOKENS)
    a = eng.add_request(pa, sampling)
    b = eng.begin_request(pb, sampling, con)
    ticks = 0
    while b in eng._prefilling:
        eng.step_mixed([a], {b: 16})                       # two chunks: 16 + 7
        ticks += 1
    assert ticks == 2 and len(eng.sequences[a].tokens) == 3
    assert _decode_all(eng, [a, b]) == [want_a, want_b]
    assert eng.fsm_loads == 1 and eng.hosted_steps == 0


def test_two_schemas_one_on_the_device_one_hosted(engines):
    jeng, model, cfg = engines
    want = [_jax_run(jeng, [257, 1], SCHEMA), _jax_run(jeng, [257, 2], SCHEMA_X)]
    eng = Engine(cfg, model=model)
    con1 = pc.json_constraint(eng.tokenizer, SCHEMA)
    con2 = pc.json_constraint(eng.tokenizer, SCHEMA_X)
    sampling = SamplingParams(max_tokens=MAX_TOKENS)
    ids = [eng.add_request(p, sampling, c) for p, c in (([257, 1], con1), ([257, 2], con2))]
    assert eng._fsm_loaded is con1.fsm                    # the first one seated
    got = _decode_all(eng, ids)
    assert got == want
    assert _live_prefix(con1.fsm, got[0]) and _live_prefix(con2.fsm, got[1])
    # con2 rode the host until con1's row finished, then its own tables.
    assert eng.hosted_steps > 0 and eng.fsm_loads in (1, 2)


def test_mask_that_raises_fails_admission():
    eng = Engine(EngineConfig(model="tiny-test", dtype=torch.float32, device="cpu", **KW))

    def broken(toks):
        raise RuntimeError("no grammar")

    from opsagent_tpu_torch.serving.kvcache import InvalidRequest

    with pytest.raises(InvalidRequest, match="mask_fn failed"):
        eng.begin_request([257, 1], SamplingParams(max_tokens=4), broken)
    assert not eng.sequences and eng.alloc.accounting()["owned"] == 0


# -- sampled rows ----------------------------------------------------------------
def test_sampler_never_picks_a_masked_token():
    """Forbidden logits far above the allowed ones, two allowed tokens,
    temperature down to its 1e-6 floor: no path picks a forbidden token."""
    gen = torch.Generator().manual_seed(0)
    B, V = 8, 512
    logits = torch.randn(B, V, generator=gen)
    allowed = torch.zeros(B, V, dtype=torch.bool)
    allowed[:, [7, 300]] = True
    logits[~allowed] += 50.0
    temps = torch.tensor([0.0, 1e-6, 1.0, 1.0, 2.0, 1e-6, 0.7, 1.0])
    top_k = torch.tensor([0, 0, 0, 5, 5, 5, 64, 0], dtype=torch.int32)
    top_p = torch.tensor([1.0, 1.0, 1.0, 1.0, 0.9, 1.0, 0.5, 0.3])
    for _ in range(50):
        tok = sample(logits, gen, temps, top_k, top_p, allowed)
        assert allowed[torch.arange(B), tok].all()
    masked = torch.where(allowed, logits, NEG_INF)
    assert torch.equal(sample(logits, gen, temps, top_k, top_p, allowed)[:1],
                       masked.argmax(-1)[:1])


@pytest.mark.parametrize("sampling", [SamplingParams(temperature=1.0, max_tokens=40),
                                      SamplingParams(temperature=1.0, top_k=5,
                                                     max_tokens=40)])
def test_sampled_rows_stay_in_the_grammar(engines, sampling):
    """Sampled rows on the device tables (the ToolPrompt schema) and hosted
    (json_object behind a plain callable) over a seeded run: every token
    is one its mask allows."""
    _, model, cfg = engines
    eng = Engine(cfg, model=model)
    tp = [pc.json_constraint(eng.tokenizer, pc.TOOLPROMPT_SCHEMA) for _ in range(2)]
    anyj = pc.json_constraint(eng.tokenizer, None)
    outs = eng.generate([[257, 1], [257, 2], [257, 3]], sampling,
                        mask_fn=[tp[0], tp[1], lambda toks: anyj(toks)])
    assert eng.hosted_steps > 0 and eng._fsm_loaded is tp[0].fsm
    for out, fsm in zip(outs, (tp[0].fsm, tp[1].fsm, anyj.fsm)):
        assert out and _live_prefix(fsm, out)


def test_mixed_tick_advances_only_the_rows_that_emit():
    """``mixed_step_body`` masks every row by its table row and advances
    ``fsm`` through the destination table only where ``emits`` is set."""
    tok = ByteTokenizer(TINY_TEST.vocab_size)
    fsm = pc.json_constraint(tok, SCHEMA).fsm
    mask, dest = fsm.dense_tables()
    tables = FsmTables.empty(3, TINY_TEST.vocab_size, mask.shape[0], torch.device("cpu"))
    model = Llama(TINY_TEST, torch.float32, "cpu", seed=0)
    cache = model.make_cache(16, 4)
    state = MixedState.empty(3, 8, 4, torch.device("cpu"))
    table = np.array([[1, 2, -1, -1], [3, 4, -1, -1], [-1] * 4], np.int32)
    rows = np.array([1, 1, 0], np.int32)                  # DFA start, twice; FREE
    with torch.inference_mode():
        tables.load(mask, dest)
        state.load(np.tile(np.arange(40, 48), (3, 1)), np.zeros(3, np.int32),
                   np.array([8, 5, 3], np.int32), table, np.zeros(3, np.float32),
                   np.zeros(3, np.int32), np.ones(3, np.float32), rows,
                   np.array([True, False, True]))
        mixed_step_body(model, state, cache, torch.Generator(), plain=True, tables=tables)
    out, got = state.out.tolist(), state.fsm.tolist()
    assert out[0] == ord("{") == out[1]                   # the start allows only "{"
    assert got == [dest[1, out[0]], 1, 0]
