"""The port's chat API against the JAX package's, on the CPU: tools in the
prompt, ``tool_calls`` replies, forced ``tool_choice``, ``logit_bias`` and
penalties, logprobs and ``n`` choices.

``tiny-test`` in f32 with the JAX engine's weights on both sides
(``params_from_jax``), greedy, byte tokenizer.

- Over HTTP: the port's server and the JAX package's ``ServingStack`` answer
  the same bodies with the same choices and usage (messages, tool calls
  and finish reasons exact; logprobs within 1e-5 with the same token
  strings). Each field the JAX package refuses answers 400 naming it.
- Prompt ids with ``tools`` equal JAX's ``apply_chat_template``; under
  ``tool_choice: "none"`` those without tools. ``_parse_tool_calls`` equals
  JAX's over valid, repairable and non-call texts.
- Forced ``tool_choice`` (``"required"``, a named function, a parameter
  schema over the state limit): DFAs equal JAX's; greedy constrained
  tokens equal the JAX engine's.
- The sampler extras: adjusted logits within one f32 ulp of JAX's
  ``logits + _bias_array(...)``; logprobs and the top 20 equal
  ``log_softmax`` and ``top_k`` (padded ids excluded); greedy tokens equal
  JAX's with a bias of +-100 and with penalties, in a decode block and in a
  mixed tick beside an admitting prompt; logprobs within 1e-5 of the JAX
  engine's ``logprob_data``, top ids equal apart from ties.
- Counterparts of ``tests/test_logit_bias.py``, ``tests/test_logprobs.py``
  and ``tests/test_tool_choice.py`` on the port.
"""

import json
import threading
import urllib.error
import urllib.request
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opsagent_tpu.models import llama as jllama
from opsagent_tpu.serving import constrained as jc
from opsagent_tpu.serving.api import ServingStack as JaxStack
from opsagent_tpu.serving.chat_template import apply_chat_template as jax_template
from opsagent_tpu.serving.engine import Engine as JaxEngine
from opsagent_tpu.serving.engine import EngineConfig as JaxEngineConfig
from opsagent_tpu.serving.engine import Sequence as JaxSequence
from opsagent_tpu.serving.sampler import SamplingParams as JaxSamplingParams
from opsagent_tpu.serving.scheduler import RequestError as JaxRequestError
from opsagent_tpu.serving.tokenizer import ByteTokenizer as JaxByteTokenizer
from opsagent_tpu_torch.models.config import TINY_TEST
from opsagent_tpu_torch.models.convert import params_from_jax
from opsagent_tpu_torch.models.llama import Llama
from opsagent_tpu_torch.serving import constrained as pc
from opsagent_tpu_torch.serving.api import ServingStack, make_server
from opsagent_tpu_torch.serving.decode_loop import LOGPROB_TOP, SamplingExtras
from opsagent_tpu_torch.serving.engine import Engine, EngineConfig
from opsagent_tpu_torch.serving.sampler import SamplingParams
from opsagent_tpu_torch.serving.scheduler import RequestError
from opsagent_tpu_torch.serving.tokenizer import ByteTokenizer

KW = dict(page_size=8, num_pages=1024, max_pages_per_seq=128, max_batch_size=4)
JAX_KW = dict(model="tiny-test", dtype=jnp.float32, tp=1, prefill_buckets=(16, 64), **KW)
LP_TOL = 1e-5
TOOLS = [
    {"type": "function", "function": {
        "name": "kubectl", "description": "run kubectl",
        "parameters": {"type": "object", "properties": {"command": {"type": "string"}}},
    }},
    {"type": "function", "function": {
        "name": "trivy",
        "parameters": {"type": "object", "properties": {"image": {"type": "string"}}},
    }},
]
# A parameter schema whose envelope compiles to 38,409 DFA states, more
# than the any-JSON envelope's 30,845 (the limit the test sets; 30,827
# with the three names that test lists).
WIDE = {"type": "object", "properties": {k: {} for k in "abcde"}}
ANY_ENVELOPE_STATES = 30_845
# tests/test_tool_choice.py's: inside a string the quote wins, after it
# '}' then ']' wherever the grammar allows them, so an envelope closes in
# tens of tokens whatever the weights.
CLOSE_BIAS = {str(ord('"')): 100, str(ord('}')): 99, str(ord(']')): 98}
MSG = [{"role": "user", "content": "scan the image"}]


@pytest.fixture(scope="module")
def engines():
    """(JAX engine driven directly, port model with its weights, port
    engine config)."""
    jeng = JaxEngine(JaxEngineConfig(**JAX_KW))
    model = Llama(TINY_TEST, torch.float32, "cpu", seed=None)
    model.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, jeng.params),
                                          TINY_TEST))
    cfg = EngineConfig(model="tiny-test", dtype=torch.float32, device="cpu",
                       decode_block=8, seed=0, **KW)
    return jeng, model, cfg


@pytest.fixture(scope="module")
def stacks(engines):
    """(JAX ServingStack over its own engine of the same weights, the
    port's ServingStack, the port server's base URL)."""
    _, model, cfg = engines
    jstack = JaxStack(JaxEngine(JaxEngineConfig(**JAX_KW)), restart_tolerant=False)
    stack = ServingStack(Engine(cfg, model=model))
    srv = make_server(stack, "127.0.0.1", 0)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    yield jstack, stack, f"http://127.0.0.1:{srv.server_address[1]}"
    srv.shutdown()
    srv.server_close()
    stack.close()
    jstack.close()
    thread.join(timeout=10)
    assert not thread.is_alive()


def post(base, body):
    req = urllib.request.Request(
        base + "/v1/chat/completions", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"},
    )
    try:
        with urllib.request.urlopen(req, timeout=300) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def assert_same_choices(got, want):
    assert got["usage"] == want["usage"]
    assert len(got["choices"]) == len(want["choices"])
    for g, w in zip(got["choices"], want["choices"]):
        assert (g["index"], g["message"], g["finish_reason"]) == (
            w["index"], w["message"], w["finish_reason"])
        assert ("logprobs" in g) == ("logprobs" in w)
        if "logprobs" in w:
            ge, we = g["logprobs"]["content"], w["logprobs"]["content"]
            assert len(ge) == len(we)
            for a, b in zip(ge, we):
                assert a["token"] == b["token"]
                assert abs(a["logprob"] - b["logprob"]) <= LP_TOL
                assert len(a["top_logprobs"]) == len(b["top_logprobs"])
                for x, y in zip(a["top_logprobs"], b["top_logprobs"]):
                    assert abs(x["logprob"] - y["logprob"]) <= LP_TOL


BODIES = {
    "tools_auto": {"messages": MSG, "tools": TOOLS, "tool_choice": "auto", "max_tokens": 16},
    "tools_none": {"messages": MSG, "tools": TOOLS, "tool_choice": "none", "max_tokens": 16},
    "required": {"messages": MSG, "tools": TOOLS, "tool_choice": "required",
                 "logit_bias": CLOSE_BIAS, "max_tokens": 512},
    "named": {"messages": MSG, "tools": TOOLS, "logit_bias": CLOSE_BIAS, "max_tokens": 512,
              "tool_choice": {"type": "function", "function": {"name": "trivy"}}},
    "logit_bias": {"messages": MSG, "logit_bias": {"123": 100, "7": -100}, "max_tokens": 5},
    "penalties": {"messages": MSG, "presence_penalty": 1.5, "frequency_penalty": 2.0,
                  "max_tokens": 24},
    "logprobs": {"messages": MSG, "logprobs": True, "top_logprobs": 5, "max_tokens": 12},
    "logprobs_stop": {"messages": MSG, "logprobs": True, "top_logprobs": 2,
                      "max_tokens": 24, "stop": None},   # stop set from the reply
    "n": {"messages": MSG, "n": 3, "max_tokens": 4},
    "n_named": {"messages": MSG, "tools": TOOLS, "n": 2, "max_tokens": 512,
                "logit_bias": {str(ord('"')): 100},
                "tool_choice": {"type": "function", "function": {"name": "kubectl"}}},
}


@pytest.mark.parametrize("name", list(BODIES))
def test_http_answers_equal_jax(stacks, name):
    jstack, _, base = stacks
    body = dict(BODIES[name], temperature=0)
    if name == "logprobs_stop":
        plain = jstack.chat_completion(dict(body, stop=[]))["choices"][0]["message"]["content"]
        body["stop"] = [plain[7:9]]
    want = jstack.chat_completion(json.loads(json.dumps(body)))
    status, got = post(base, body)
    assert status == 200, got
    assert_same_choices(got, want)
    if name in ("required", "named", "n_named"):
        for ch in got["choices"]:
            assert ch["finish_reason"] == "tool_calls" and ch["message"]["content"] is None
            call = ch["message"]["tool_calls"][0]
            assert call["function"]["name"] in {"required": ("kubectl", "trivy"),
                                                "named": ("trivy",),
                                                "n_named": ("kubectl",)}[name]
            if name != "required":
                # Under "required" the arguments are any JSON value: here,
                # in both packages, the JSON string "}".
                json.loads(call["function"]["arguments"])
    if name == "logprobs_stop":
        ch = got["choices"][0]
        assert ch["finish_reason"] == "stop"
        text = "".join(e["token"] for e in ch["logprobs"]["content"])
        assert len(ch["logprobs"]["content"]) < got["usage"]["completion_tokens"]
        assert ch["message"]["content"].startswith(text)


REFUSED = [  # (extra fields, words of the message, streamed or not)
    ({"n": 9}, "n must be in 1..8", False),
    ({"n": 9}, "n > 1", True),
    ({"n": 2}, "n > 1", True),
    ({"logprobs": True}, "logprobs", True),
    ({"logprobs": True, "top_logprobs": 21}, "top_logprobs", None),
    ({"top_logprobs": 3}, "top_logprobs", None),
    ({"logit_bias": {"5": 101}}, "logit_bias", None),
    ({"logit_bias": [5]}, "logit_bias", None),
    ({"presence_penalty": 3}, "penalties", None),
    ({"frequency_penalty": -2.5}, "penalties", None),
    ({"tool_choice": "required"}, "tool_choice", None),
    ({"tools": TOOLS, "tool_choice": {"type": "function", "function": {"name": "nope"}}},
     "unknown function", None),
    ({"tools": TOOLS, "tool_choice": "any"}, "tool_choice", None),
    ({"tools": TOOLS, "tool_choice": "required", "response_format": {"type": "json_object"}},
     "response_format", None),
]


@pytest.mark.parametrize("extra,words,streamed", [
    (e, w, s) for e, w, modes in REFUSED for s in ((False, True) if modes is None else (modes,))
])
def test_jax_refusals_answer_400_in_both(stacks, extra, words, streamed):
    jstack, _, base = stacks
    body = {"messages": MSG, "max_tokens": 4, "stream": streamed, **extra}
    with pytest.raises(JaxRequestError) as jax_err:
        if streamed:
            next(jstack.chat_completion_stream(dict(body)))
        else:
            jstack.chat_completion(dict(body))
    status, got = post(base, body)
    assert status == 400 and jax_err.value.status == 400
    assert words in got["error"]["message"] and words in str(jax_err.value)


# -- prompts and tool_calls parsing ----------------------------------------------
@pytest.mark.parametrize("tool_choice", [None, "auto", "none", "required"])
def test_prompt_ids_with_tools_equal_jax(stacks, tool_choice):
    _, stack, _ = stacks
    messages = [{"role": "system", "content": "You are an ops agent."},
                {"role": "user", "content": "list the pods"}]
    body = {"messages": messages, "tools": TOOLS}
    if tool_choice:
        body["tool_choice"] = tool_choice
    _, ids, _ = stack._translate(body)
    tok = JaxByteTokenizer(TINY_TEST.vocab_size)
    tools = None if tool_choice == "none" else TOOLS
    assert ids == jax_template(tok, messages, model_family="tiny-test", tools=tools)
    assert (ids == jax_template(tok, messages, model_family="tiny-test")) == (tools is None)


TOOL_TEXTS = [
    '{"tool_calls": [{"id": "c1", "type": "function", "function": '
    '{"name": "kubectl", "arguments": "{\\"command\\": \\"get pods\\"}"}}]}',
    '{"tool_calls": [{"function": {"name": "trivy", "arguments": {"image": "nginx"}}}]}',
    '  {"tool_calls":[{"function":{"name":"a"}},{"function":{"name":"b","arguments":"{}"}}]}\n',
    '```json\n{"tool_calls": [{"function": {"name": "kubectl", "arguments": "{}"}},]}\n```',
    'Sure: {"tool_calls": [{"function": {"name": "kubectl", "arguments": {"x": "1\n2"}}}',
    '{"tool_calls": []}',
    '{"tool_calls": "kubectl"}',
    '["tool_calls"]',
    'no call here',
    '{"content": "the word \\"tool_calls\\" in prose"}',
    '{"tool_calls": [{"function": {"name": "kubectl"',
    '',
]


@pytest.mark.parametrize("text", TOOL_TEXTS)
def test_parse_tool_calls_equals_jax(text):
    assert ServingStack._parse_tool_calls(text) == JaxStack._parse_tool_calls(text)


# -- forced tool_choice ------------------------------------------------------------
CHOICES = {
    "required": ("required", TOOLS),
    "named": ({"type": "function", "function": {"name": "kubectl"}}, TOOLS),
    "over_limit": ({"type": "function", "function": {"name": "wide"}},
                   TOOLS + [{"type": "function", "function": {"name": "wide",
                                                              "parameters": WIDE}}]),
}


@pytest.mark.parametrize("kind", list(CHOICES))
def test_tool_choice_dfa_equals_jax(stacks, monkeypatch, kind):
    jstack, stack, _ = stacks
    tc, tools = CHOICES[kind]
    if kind == "over_limit":
        monkeypatch.setattr(pc, "MAX_DFA_STATES", ANY_ENVELOPE_STATES)
        monkeypatch.setattr(jc, "MAX_DFA_STATES", ANY_ENVELOPE_STATES)
    body = {"messages": MSG, "tools": tools, "tool_choice": tc}
    want = jstack._tool_choice_constraint(body).fsm.dfa
    got = stack._tool_choice_constraint(body).fsm.dfa
    np.testing.assert_array_equal(got.next, want.next)
    np.testing.assert_array_equal(got.accept, want.accept)
    assert got.start == want.start
    if kind == "over_limit":
        # The parameter schema is over the limit: any-JSON arguments.
        assert got.num_states == 30_827


def _jax_tokens(jeng, prompt, sampling, mask_fn=None):
    """The JAX engine's tokens (and logprob_data) for one prompt alone."""
    sid = jeng.begin_request(prompt, sampling, mask_fn=mask_fn)
    while not jeng.prefill_step(sid):
        pass
    while not jeng.sequences[sid].done:
        jeng.step_block([sid])
    data = list(jeng.sequences[sid].logprob_data)
    return jeng.finish(sid), data


@pytest.mark.parametrize("kind", ["required", "named"])
def test_forced_tool_choice_tokens_equal_jax_engine(engines, stacks, kind):
    jeng, model, cfg = engines
    jstack, stack, _ = stacks
    tc, tools = CHOICES[kind]
    body = {"messages": MSG, "tools": tools, "tool_choice": tc, "logit_bias": CLOSE_BIAS}
    prompt = stack._translate(body)[1]
    bias = tuple((int(k), float(v)) for k, v in CLOSE_BIAS.items())
    want, _ = _jax_tokens(jeng, prompt, JaxSamplingParams(max_tokens=256, logit_bias=bias),
                          jstack._tool_choice_constraint(body))
    eng = Engine(cfg, model=model)
    con = stack._tool_choice_constraint(body)
    got = eng.generate([prompt], SamplingParams(max_tokens=256, logit_bias=bias),
                       mask_fn=[con])[0]
    assert got == want and got[-1] == eng.tokenizer.eos_id
    assert eng.hosted_steps == 0 and eng.fsm_loads == 1
    calls = ServingStack._parse_tool_calls(eng.tokenizer.decode(got[:-1]))
    assert calls and calls[0]["function"]["name"] in ("kubectl", "trivy")


# -- the sampler extras against JAX's ----------------------------------------------
def test_adjusted_logits_within_one_ulp_of_jax_bias_array():
    rng = np.random.default_rng(0)
    B, V = 4, 512
    logits = rng.normal(0, 4, (B, V)).astype(np.float32)
    params = [
        JaxSamplingParams(logit_bias=((3, 100.0), (9, -100.0), (77, 0.5), (600, 1.0))),
        JaxSamplingParams(presence_penalty=0.7, frequency_penalty=1.3),
        JaxSamplingParams(logit_bias=((5, -2.25),), presence_penalty=-2.0,
                          frequency_penalty=0.1, penalty_history=(5, 5, 8)),
        JaxSamplingParams(),
    ]
    counts = [None, {4: 3, 10: 1, 511: 7}, {5: 2, 8: 1, 20: 4}, None]
    seqs = []
    for i, (p, c) in enumerate(zip(params, counts)):
        s = JaxSequence(i, 1, params=p)
        s.penalty_counts = c
        seqs.append(s)
    fake = SimpleNamespace(model_cfg=SimpleNamespace(vocab_size=V), _bias_buf=None,
                           _needs_bias=JaxEngine._needs_bias)
    want = logits + JaxEngine._bias_array(fake, seqs, B)

    x = SamplingExtras.empty(B, V, 4, V, torch.device("cpu"))
    for i, (p, c) in enumerate(zip(params, counts)):
        for tid, b in p.logit_bias:
            if tid < V:
                x.bias[i, tid] += b
        for tid, n in (c or {}).items():
            x.counts[i, tid] = n
        x.pres[i], x.freq[i] = p.presence_penalty, p.frequency_penalty
    got = x.adjust(torch.from_numpy(logits)).numpy()
    ulp = np.spacing(np.abs(want).astype(np.float32))
    assert np.all(np.abs(got - want) <= ulp)
    np.testing.assert_array_equal(got, want)           # in fact bit-equal
    np.testing.assert_array_equal(got[3], logits[3])   # no extras: the logits


@pytest.mark.parametrize("renderable", [512, 300])
def test_logprobs_equal_log_softmax_and_top_k(renderable):
    rng = np.random.default_rng(1)
    B, V = 3, 512
    adj = rng.normal(0, 3, (B, V)).astype(np.float32)
    tok = np.array([5, 400, 299])
    x = SamplingExtras.empty(B, V, 4, renderable, torch.device("cpu"))
    chosen, ids, top = x.logprobs(torch.from_numpy(adj), torch.from_numpy(tok))
    lp = jax.nn.log_softmax(jnp.asarray(adj), axis=-1)
    want_chosen = np.take_along_axis(np.asarray(lp), tok[:, None], 1)[:, 0]
    lp = jnp.where(jnp.arange(V)[None, :] < renderable, lp, -jnp.inf)
    want_top, want_ids = jax.lax.top_k(lp, LOGPROB_TOP)
    np.testing.assert_allclose(chosen.numpy(), want_chosen, atol=LP_TOL, rtol=0)
    np.testing.assert_allclose(top.numpy(), np.asarray(want_top), atol=LP_TOL, rtol=0)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(want_ids))
    assert ids.dtype == torch.int32 and int(ids.max()) < renderable


EXTRAS = {
    "bias_plus_100": SamplingParams(max_tokens=12, logit_bias=((123, 100.0),)),
    "bias_minus_100": SamplingParams(max_tokens=12, logit_bias=((0, -100.0), (1, -100.0),
                                                                  (10, -100.0))),
    "penalties": SamplingParams(max_tokens=24, presence_penalty=0.8, frequency_penalty=1.7),
    "logprobs": SamplingParams(max_tokens=12, logprobs=True, top_logprobs=5),
    "all": SamplingParams(max_tokens=16, logit_bias=((44, 3.0),), presence_penalty=0.5,
                          frequency_penalty=0.5, logprobs=True, top_logprobs=20),
}


def _jax_params(p: SamplingParams) -> JaxSamplingParams:
    return JaxSamplingParams(
        max_tokens=p.max_tokens, logprobs=p.logprobs, top_logprobs=p.top_logprobs,
        logit_bias=p.logit_bias, presence_penalty=p.presence_penalty,
        frequency_penalty=p.frequency_penalty,
    )


def assert_logprobs_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert abs(g["logprob"] - w["logprob"]) <= LP_TOL
        assert len(g["top"]) == len(w["top"])
        for (gi, gl), (wi, wl) in zip(g["top"], w["top"]):
            assert abs(gl - wl) <= LP_TOL
            # Ids may trade places only where their logprobs tie.
            assert gi == wi or abs(gl - dict(w["top"]).get(gi, np.inf)) <= LP_TOL


@pytest.mark.parametrize("where", ["block", "mixed"])
@pytest.mark.parametrize("name", list(EXTRAS))
def test_extras_tokens_equal_jax(engines, name, where):
    """``block``: the row admitted alone, then decode blocks. ``mixed``: the
    row decodes in the mixed ticks that admit a plain prompt beside it,
    then both decode in blocks; the plain row's tokens are JAX's too."""
    jeng, model, cfg = engines
    sampling = EXTRAS[name]
    prompt, other = [257, 9, 8, 7], [257] + list(range(30, 52))
    want, want_lp = _jax_tokens(jeng, prompt, _jax_params(sampling))
    eng = Engine(cfg, model=model)
    a = eng.add_request(prompt, sampling)
    if where == "mixed":
        want_b, _ = _jax_tokens(jeng, other, JaxSamplingParams(max_tokens=12))
        b = eng.begin_request(other, SamplingParams(max_tokens=12))
        ticks = 0
        while b in eng._prefilling:
            eng.step_mixed([a], {b: 16})
            ticks += 1
        assert ticks == 2 and len(eng.sequences[a].tokens) == 3
    ids = [a] + ([b] if where == "mixed" else [])
    while any(not eng.sequences[i].done for i in ids):
        eng.step_block([i for i in ids if not eng.sequences[i].done])
    got_lp = list(eng.sequences[a].logprob_data)
    got = [eng.finish(i) for i in ids]
    assert got[0] == want
    if where == "mixed":
        assert got[1] == want_b
    assert_logprobs_equal(got_lp, want_lp)
    assert eng.decode_eager_steps > 0 and eng.hosted_steps == 0


def test_extras_rows_keep_full_blocks_and_plain_rows_unchanged(engines):
    """A bias row, a penalty row and a logprobs row decode in one block with
    a plain row: every row advances a full block per call, and the plain
    row's tokens are those of a run with no extras beside it."""
    _, model, cfg = engines
    plain = SamplingParams(max_tokens=24)
    eng = Engine(cfg, model=model)
    alone = eng.generate([[257, 1, 2, 3]], plain)[0]
    rows = [(plain, [257, 1, 2, 3]), (EXTRAS["bias_plus_100"], [257, 4]),
            (EXTRAS["penalties"], [257, 5]), (EXTRAS["logprobs"], [257, 6])]
    ids = [eng.add_request(p, s) for s, p in rows]
    out = eng.step_block(ids)
    assert [len(out[i]) for i in ids] == [cfg.decode_block] * 4
    while any(not eng.sequences[i].done for i in ids):
        eng.step_block([i for i in ids if not eng.sequences[i].done])
    assert eng.finish(ids[0]) == alone
    assert eng.hosted_steps == 0


def test_extras_loads_copy_nothing_for_plain_batches(engines, monkeypatch):
    """Host-to-device copies of the extras (the engine module's
    ``torch.from_numpy``) and the steps without them: none for plain
    batches, some for a penalty row; a plain batch after it copies
    nothing and runs the body without the extras; a logprobs row then
    zeroes the penalty row's pres and freq once, and copies nothing more."""
    from opsagent_tpu_torch.serving import engine as engine_module

    _, model, cfg = engines
    eng = Engine(cfg, model=model)
    copies = []

    class Recording:
        def __getattr__(self, name):
            return getattr(torch, name)

        @staticmethod
        def from_numpy(a):
            copies.append(a.shape)
            return torch.from_numpy(a)

    bodies = []
    decode_body = eng._decode_body

    def recorded(greedy, extras, generator):
        bodies.append(extras)
        return decode_body(greedy, extras, generator)

    monkeypatch.setattr(engine_module, "torch", Recording())
    monkeypatch.setattr(eng, "_decode_body", recorded)
    eng.generate([[257, 1], [257, 2]], SamplingParams(max_tokens=12))
    assert copies == [] and bodies and not any(bodies)
    eng.generate([[257, 1]], SamplingParams(max_tokens=4, presence_penalty=1.0))
    assert copies and bodies[-1]
    copies.clear()
    eng.generate([[257, 1]], SamplingParams(max_tokens=4))
    assert copies == [] and not bodies[-1]
    eng.generate([[257, 1]], SamplingParams(max_tokens=4, logprobs=True))
    assert copies == [(cfg.max_batch_size,)] * 2          # pres and freq, zeroed
    copies.clear()
    eng.generate([[257, 1]], SamplingParams(max_tokens=4, logprobs=True))
    assert copies == [] and bodies[-1]


# -- counterparts of tests/test_logit_bias.py ---------------------------------------
@pytest.fixture(scope="module")
def engine(engines):
    _, model, cfg = engines
    return Engine(cfg, model=model)


def test_negative_bias_forbids_greedy_choice(engine):
    prompt = [257, 3, 4, 5]
    free = engine.generate([prompt], SamplingParams(max_tokens=1))[0][0]
    out = engine.generate([prompt], SamplingParams(max_tokens=1,
                                                   logit_bias=((free, -100.0),)))[0]
    assert out[0] != free


def test_positive_bias_forces_token(engine):
    out = engine.generate([[257, 1, 2]], SamplingParams(max_tokens=3,
                                                        logit_bias=((123, 100.0),)))[0]
    assert out == [123, 123, 123]


def test_frequency_penalty_breaks_repetition(engine):
    base = engine.generate([[257, 6, 6, 6]], SamplingParams(max_tokens=16))[0]
    pen = engine.generate([[257, 6, 6, 6]],
                          SamplingParams(max_tokens=16, frequency_penalty=2.0))[0]
    assert len(set(pen)) >= len(set(base))


def test_api_parses_and_validates_bias(stacks):
    _, stack, _ = stacks
    resp = stack.chat_completion({"messages": [{"role": "user", "content": "x"}],
                                  "max_tokens": 2, "temperature": 0,
                                  "logit_bias": {"42": 5}, "presence_penalty": 0.5})
    assert resp["usage"]["completion_tokens"] == 2
    for bad in ({"logit_bias": {"42": 101}}, {"presence_penalty": 3.0}):
        with pytest.raises(RequestError):
            stack.chat_completion({"messages": [{"role": "user", "content": "x"}], **bad})


def test_biased_row_composes_with_plain_batch(engine):
    want = engine.generate([[257, 9, 8, 7]], SamplingParams(max_tokens=5))[0]
    a = engine.add_request([257, 9, 8, 7], SamplingParams(max_tokens=5))
    b = engine.add_request([257, 2, 3], SamplingParams(max_tokens=5,
                                                       logit_bias=((50, 100.0),)))
    while not (engine.sequences[a].done and engine.sequences[b].done):
        engine.step_block([i for i in (a, b) if not engine.sequences[i].done])
    assert engine.finish(a) == want
    assert engine.finish(b) == [50] * 5


# -- counterparts of tests/test_logprobs.py -------------------------------------------
def test_engine_logprobs_match_oracle(engines, engine):
    jeng = engines[0]
    prompt = [257, 5, 6, 7]
    sid = engine.add_request(prompt, SamplingParams(max_tokens=4, logprobs=True,
                                                    top_logprobs=3))
    while not engine.sequences[sid].done:
        engine.step_block([sid])
    data = list(engine.sequences[sid].logprob_data)
    toks = engine.finish(sid)
    assert len(data) == len(toks)
    ctx = list(prompt)
    for t, d in zip(toks, data):
        logits = jllama.forward_full(jeng.params, jeng.model_cfg, jnp.asarray([ctx]),
                                     dtype=jnp.float32)
        lp = np.asarray(jax.nn.log_softmax(logits[0, -1]))
        assert abs(float(lp[t]) - d["logprob"]) < 1e-3
        assert [i for i, _ in d["top"]] == np.argsort(-lp)[:3].tolist()
        assert d["top"][0][1] >= d["top"][1][1] >= d["top"][2][1]
        ctx.append(t)


def test_logprobs_without_top(engine):
    sid = engine.add_request([257, 9], SamplingParams(max_tokens=2, logprobs=True))
    while not engine.sequences[sid].done:
        engine.step_block([sid])
    data = list(engine.sequences[sid].logprob_data)
    engine.finish(sid)
    assert len(data) == 2
    assert all(d["top"] == [] and d["logprob"] <= 0.0 for d in data)


def test_chat_completion_logprobs_shape(stacks):
    _, stack, _ = stacks
    resp = stack.chat_completion({"messages": [{"role": "user", "content": "hello"}],
                                  "max_tokens": 3, "temperature": 0,
                                  "logprobs": True, "top_logprobs": 2})
    ent = resp["choices"][0]["logprobs"]["content"][0]
    assert isinstance(ent["token"], str) and ent["logprob"] <= 0.0
    assert len(ent["top_logprobs"]) == 2
    assert ent["top_logprobs"][0]["logprob"] >= ent["top_logprobs"][1]["logprob"]
    plain = stack.chat_completion({"messages": [{"role": "user", "content": "hello"}],
                                   "max_tokens": 3, "temperature": 0})
    assert "logprobs" not in plain["choices"][0]


def test_top_logprobs_validation(stacks):
    _, stack, _ = stacks
    for bad in ({"top_logprobs": 3}, {"logprobs": True, "top_logprobs": 21}):
        with pytest.raises(RequestError):
            stack.chat_completion({"messages": [{"role": "user", "content": "x"}], **bad})


def test_logprobs_row_does_not_block_plain_batch(engine):
    want = engine.generate([[257, 1, 2, 3]], SamplingParams(max_tokens=5))[0]
    a = engine.add_request([257, 1, 2, 3], SamplingParams(max_tokens=5))
    b = engine.add_request([257, 8, 9], SamplingParams(max_tokens=5, logprobs=True))
    while not (engine.sequences[a].done and engine.sequences[b].done):
        engine.step_block([i for i in (a, b) if not engine.sequences[i].done])
    lp_len = len(engine.sequences[b].logprob_data)
    assert engine.finish(a) == want
    assert lp_len == len(engine.finish(b))


def test_stream_with_logprobs_rejected(stacks):
    _, stack, _ = stacks
    gen = stack.chat_completion_stream({"messages": [{"role": "user", "content": "x"}],
                                        "stream": True, "logprobs": True})
    with pytest.raises(RequestError, match="stream"):
        next(gen)


# -- counterparts of tests/test_tool_choice.py ------------------------------------------
def test_forced_function_emits_valid_call(stacks):
    _, stack, _ = stacks
    resp = stack.chat_completion({
        "messages": MSG, "tools": TOOLS, "logit_bias": dict(CLOSE_BIAS),
        "tool_choice": {"type": "function", "function": {"name": "trivy"}},
        "max_tokens": 512, "temperature": 0,
    })
    choice = resp["choices"][0]
    assert choice["finish_reason"] == "tool_calls"
    call = choice["message"]["tool_calls"][0]
    assert call["function"]["name"] == "trivy"
    json.loads(call["function"]["arguments"])


def test_required_constrains_to_listed_tools(stacks):
    _, stack, _ = stacks
    resp = stack.chat_completion({
        "messages": [{"role": "user", "content": "do something"}], "tools": TOOLS,
        "tool_choice": "required", "logit_bias": dict(CLOSE_BIAS), "max_tokens": 512,
        "temperature": 0,
    })
    calls = resp["choices"][0]["message"]["tool_calls"]
    assert calls[0]["function"]["name"] in ("kubectl", "trivy")


def test_tool_choice_validation(stacks):
    _, stack, _ = stacks
    for bad in ({"tool_choice": "required"},
                {"tools": TOOLS, "tool_choice": {"type": "function",
                                                 "function": {"name": "nope"}}},
                {"tools": TOOLS, "tool_choice": "required",
                 "response_format": {"type": "json_object"}}):
        with pytest.raises(RequestError):
            stack.chat_completion({"messages": [{"role": "user", "content": "x"}], **bad})


def test_n_choices(stacks):
    _, stack, _ = stacks
    resp = stack.chat_completion({"messages": [{"role": "user", "content": "hello"}],
                                  "max_tokens": 4, "temperature": 0, "n": 3})
    assert [c["index"] for c in resp["choices"]] == [0, 1, 2]
    assert len({c["message"]["content"] for c in resp["choices"]}) == 1
    assert resp["usage"]["completion_tokens"] == 12
    with pytest.raises(RequestError):
        stack.chat_completion({"messages": [{"role": "user", "content": "x"}], "n": 9})
    with pytest.raises(RequestError):
        next(stack.chat_completion_stream({"messages": [{"role": "user", "content": "x"}],
                                           "stream": True, "n": 2}))


def test_n_choices_with_constraint_use_distinct_fsm_walkers(stacks, monkeypatch):
    _, stack, _ = stacks
    submitted = []
    submit = stack.scheduler.submit

    def record(req):
        submitted.append(req.mask_fn)
        return submit(req)

    monkeypatch.setattr(stack.scheduler, "submit", record)
    resp = stack.chat_completion({
        "messages": [{"role": "user", "content": "go"}], "tools": TOOLS,
        "tool_choice": {"type": "function", "function": {"name": "kubectl"}},
        "logit_bias": {str(ord('"')): 100}, "max_tokens": 512, "temperature": 0, "n": 2,
    })
    assert len(submitted) == 2 and submitted[0] is not submitted[1]
    assert submitted[0].fsm is submitted[1].fsm                # one table set
    for c in resp["choices"]:
        assert c["finish_reason"] == "tool_calls", c
        assert c["message"]["tool_calls"][0]["function"]["name"] == "kubectl"


def test_byte_tokenizer_token_str_equals_jax():
    ours, theirs = ByteTokenizer(512), JaxByteTokenizer(512)
    assert [ours.token_str(i) for i in range(512)] == [theirs.token_str(i) for i in range(512)]
