"""The port's serving engine against the JAX package's, on the CPU.

``tiny-test`` f32 with the same weights in both engines and the prefix cache
on. Each engine admits a prompt, admits a second one in mixed steps beside
the first one's decode lane, block-decodes both, then serves a prompt that
shares the first one's prefix: greedy tokens are identical.
"""

import json
import threading
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opsagent_tpu.serving.engine import Engine as JaxEngine
from opsagent_tpu.serving.engine import EngineConfig as JaxEngineConfig
from opsagent_tpu.serving.sampler import SamplingParams as JaxSamplingParams
from opsagent_tpu_torch.models.config import TINY_TEST
from opsagent_tpu_torch.models.convert import params_from_jax
from opsagent_tpu_torch.models.llama import Llama
from opsagent_tpu_torch.serving.api import ServingStack, make_server
from opsagent_tpu_torch.serving.engine import Engine, EngineConfig
from opsagent_tpu_torch.serving.sampler import SamplingParams

MAX_TOKENS = 10
SHAPE = dict(page_size=4, num_pages=64, max_pages_per_seq=32, max_batch_size=4,
             decode_block=4, seed=0)
P0 = [257] + list(range(40, 60))           # 21 tokens: chunk bucket 32
P1 = [257, 9, 8, 7, 6, 5, 4, 3, 2]         # 9 tokens: bucket 16
P2 = P0[:13] + [100, 101]                  # shares P0's first 3 pages


def drive(engine, sampling):
    """Admit P0; admit P1 in mixed steps while P0 decodes; block-decode
    both; finish; then serve P2, which hits P0's cached pages."""
    def admit(prompt, decoding):
        sid = engine.begin_request(prompt, sampling)
        while True:
            done, total = engine.prefill_progress(sid)
            _, out = engine.step_mixed(
                [s for s in decoding if not engine.sequences[s].done],
                {sid: total - done},
            )
            if out[sid] is True:
                return sid

    def decode_all(ids):
        while any(not engine.sequences[s].done for s in ids):
            engine.step_block([s for s in ids if not engine.sequences[s].done])
        return [engine.finish(s) for s in ids]

    a = admit(P0, [])
    b = admit(P1, [a])
    first = decode_all([a, b])
    return first + decode_all([admit(P2, [])])


@pytest.fixture(scope="module")
def engines():
    jeng = JaxEngine(JaxEngineConfig(
        model="tiny-test", dtype=jnp.float32, tp=1, pipeline_depth=0, **SHAPE
    ))
    tree = jax.tree_util.tree_map(np.asarray, jeng.params)
    model = Llama(TINY_TEST, torch.float32, "cpu", seed=None)
    model.load_state_dict(params_from_jax(tree, TINY_TEST))
    cfg = EngineConfig(model="tiny-test", dtype=torch.float32, device="cpu", **SHAPE)
    return jeng, model, cfg


def test_greedy_tokens_match_jax_engine(engines):
    jeng, model, cfg = engines
    want = drive(jeng, JaxSamplingParams(max_tokens=MAX_TOKENS))
    eng = Engine(cfg, model=model)
    got = drive(eng, SamplingParams(max_tokens=MAX_TOKENS))
    assert got == want
    assert eng.alloc.hit_tokens == jeng.alloc.hit_tokens > 0
    # generate (add_request + step_block) gives the same tokens.
    assert Engine(cfg, model=model).generate(
        [P0, P1], SamplingParams(max_tokens=MAX_TOKENS)
    ) == want[:2]
    acct = eng.alloc.accounting()
    assert acct["owned"] == 0 and acct["total"] == cfg.num_pages


def test_chat_completion_over_http(engines):
    _, model, cfg = engines
    stack = ServingStack(Engine(cfg, model=model))
    server = make_server(stack, "127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        body = {"messages": [{"role": "user", "content": "list the pods"}],
                "max_tokens": 5, "temperature": 0}
        req = urllib.request.Request(
            base + "/v1/chat/completions", data=json.dumps(body).encode(),
            headers={"Content-Type": "application/json"},
        )
        with urllib.request.urlopen(req, timeout=60) as r:
            assert r.status == 200
            reply = json.loads(r.read())
        with urllib.request.urlopen(base + "/healthz", timeout=60) as r:
            health = json.loads(r.read())
    finally:
        server.shutdown()
        server.server_close()
        stack.close()
        thread.join(timeout=10)
    assert not thread.is_alive()
    assert reply["object"] == "chat.completion"
    choice = reply["choices"][0]
    assert choice["message"]["role"] == "assistant"
    assert choice["finish_reason"] in ("stop", "length")
    usage = reply["usage"]
    assert 1 <= usage["completion_tokens"] <= 5
    assert usage["total_tokens"] == usage["prompt_tokens"] + usage["completion_tokens"]
    assert health["status"] == "ok" and health["attn_impl"] == "plain"


def test_engine_defaults_to_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Engine(EngineConfig())
    with pytest.raises(ValueError, match="needs a CUDA device"):
        Engine(EngineConfig(device="cpu", attn_impl="cuda"))
