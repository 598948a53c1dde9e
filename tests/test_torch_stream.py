"""The port's chat API over the standard-library server, on the CPU:
``stream: true`` (server-sent events), ``response_format`` (constrained
decoding) and the fields the port refuses with 400 rather than ignore.

``tiny-test`` f32 from a seed, greedy.
"""

import json
import threading
import urllib.error
import urllib.request

import pytest
import torch

from opsagent_tpu_torch.serving import constrained as pc
from opsagent_tpu_torch.serving.api import ServingStack, make_server
from opsagent_tpu_torch.serving.engine import Engine, EngineConfig

SCHEMA = {
    "type": "object",
    "properties": {
        "name": {"enum": ["kubectl", "trivy"]},
        "ok": {"type": "boolean"},
    },
}
MESSAGES = [{"role": "user", "content": "list the pods"}]


@pytest.fixture(scope="module")
def server():
    engine = Engine(EngineConfig(model="tiny-test", dtype=torch.float32, device="cpu",
                                 page_size=4, num_pages=256, max_pages_per_seq=64,
                                 max_batch_size=4, decode_block=8, seed=0))
    stack = ServingStack(engine)
    srv = make_server(stack, "127.0.0.1", 0)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    yield f"http://127.0.0.1:{srv.server_address[1]}", engine
    srv.shutdown()
    srv.server_close()
    stack.close()
    thread.join(timeout=10)
    assert not thread.is_alive()


def post(base, body):
    """(status, content type, raw body); an HTTP error's too."""
    req = urllib.request.Request(
        base + "/v1/chat/completions", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"},
    )
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, r.headers["Content-Type"], r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.headers["Content-Type"], e.read().decode()


def events(raw):
    """The SSE body's data payloads, in order."""
    assert raw.endswith("\n\n")
    out = []
    for block in raw.split("\n\n")[:-1]:
        assert block.startswith("data: "), block
        out.append(block[len("data: "):])
    return out


def stream(base, body):
    status, ctype, raw = post(base, {**body, "stream": True})
    assert status == 200 and ctype == "text/event-stream"
    data = events(raw)
    assert data[-1] == "[DONE]"
    chunks = [json.loads(d) for d in data[:-1]]
    assert all(c["object"] == "chat.completion.chunk" for c in chunks)
    assert len({c["id"] for c in chunks}) == 1 and chunks[0]["id"].startswith("chatcmpl-")
    assert chunks[0]["choices"][0]["delta"] == {"role": "assistant", "content": ""}
    last = chunks[-1]["choices"][0]
    assert last["delta"] == {} and last["finish_reason"] in ("stop", "length")
    assert all(c["choices"][0]["finish_reason"] is None for c in chunks[:-1])
    text = "".join(c["choices"][0]["delta"].get("content", "") for c in chunks[1:])
    return text, last["finish_reason"]


def complete(base, body):
    status, ctype, raw = post(base, body)
    assert status == 200 and ctype == "application/json", raw
    choice = json.loads(raw)["choices"][0]
    return choice["message"]["content"], choice["finish_reason"]


def test_stream_deltas_concatenate_to_the_completion(server):
    base, _ = server
    body = {"messages": MESSAGES, "max_tokens": 24, "temperature": 0}
    assert stream(base, body) == complete(base, body)


def test_stream_holds_back_a_stop_string(server):
    base, _ = server
    full, _ = complete(base, {"messages": MESSAGES, "max_tokens": 24})
    stop = full[5:8]
    body = {"messages": MESSAGES, "max_tokens": 24, "stop": [stop]}
    text, finish = stream(base, body)
    assert (text, finish) == complete(base, body)
    assert stop not in text and finish == "stop"


def test_prompt_past_the_context_window_answers_400(server):
    base, engine = server
    long = [{"role": "user", "content": "x" * engine.model_cfg.max_position}]
    for streamed in (True, False):
        status, ctype, raw = post(base, {"messages": long, "stream": streamed})
        assert status == 400 and ctype == "application/json"
        assert "context window" in json.loads(raw)["error"]["message"]


def _live(fsm, text):
    st = fsm.dfa.run(fsm.dfa.start, text.encode())
    return st, st >= 0


@pytest.mark.parametrize("streamed", [False, True])
def test_json_schema_content_is_a_live_prefix_and_parses_when_stopped(server, streamed):
    base, engine = server
    body = {"messages": MESSAGES, "max_tokens": 64,
            "response_format": {"type": "json_schema",
                                "json_schema": {"name": "s", "schema": SCHEMA}}}
    text, finish = (stream if streamed else complete)(base, body)
    fsm = pc.json_constraint(engine.tokenizer, SCHEMA).fsm
    st, live = _live(fsm, text)
    assert live
    # The schema's longest text is 45 bytes and only EOS follows its "}".
    assert finish == "stop" and fsm.dfa.accept[st]
    assert json.loads(text)["name"] in ("kubectl", "trivy")
    if streamed:
        assert (text, finish) == complete(base, {**body})


def test_json_object_content_is_a_live_prefix(server):
    base, engine = server
    text, finish = complete(base, {"messages": MESSAGES, "max_tokens": 32,
                                   "response_format": {"type": "json_object"}})
    fsm = pc.json_constraint(engine.tokenizer, None).fsm
    st, live = _live(fsm, text)
    assert live
    if finish == "stop":
        json.loads(text)


@pytest.mark.parametrize("extra,field", [
    ({"response_format": {"type": "yaml"}}, "response_format"),
    ({"response_format": {"type": "json_schema", "json_schema": {"name": "s"}}},
     "schema"),
    ({"response_format": "json"}, "response_format"),
    ({"response_format": {"type": "json_schema", "json_schema": {"schema": {
        "type": "array", "items": {"type": "array", "items": {
            "type": "array", "items": {"type": "array"}}}}}}}, None),
    ({"tool_choice": "required", "tools": [{"type": "function",
                                            "function": {"name": "kubectl"}}]},
     "tool_choice"),
    ({"n": 2}, "n must be 1"),
    ({"logprobs": True}, "logprobs"),
    ({"logit_bias": {"5": 10}}, "logit_bias"),
    ({"presence_penalty": 0.5}, "presence_penalty"),
])
@pytest.mark.parametrize("streamed", [False, True])
def test_unsupported_or_malformed_fields_answer_400(server, monkeypatch, extra, field,
                                                    streamed):
    base, _ = server
    if field is None:
        # A schema whose DFA is over the state limit.
        monkeypatch.setattr(pc, "MAX_DFA_STATES", 10)
        field = "DFA states"
    status, ctype, raw = post(base, {"messages": MESSAGES, "stream": streamed, **extra})
    assert status == 400 and ctype == "application/json"
    assert field in json.loads(raw)["error"]["message"]
