"""The port's in-process ``cuda://`` provider and its copy of the LLM client,
against the JAX package's ``tpu://`` provider on the CPU.

- The JAX agent loop (``opsagent_tpu.agent.react.assistant_with_config``,
  with the replay ``kubectl`` of ``scripts/train_tiny_agent.py``'s agent
  run) runs once through ``tpu://`` (the JAX ``ServingStack``) and once
  through ``cuda://`` (the port's factory registered with the JAX client
  through ``register_provider``, the JAX package unedited), on the same
  ``tiny-test`` f32 weights (``params_from_jax``): the transcripts and the
  final replies are equal. The loop asks for the ToolPrompt schema when the
  model or the base URL names ``tpu://``, so the ``cuda://`` run passes a
  ``tpu://`` base URL to send the same requests; the conveyor is off on
  both (its stream path reads the JAX stack registry).
- The same with learned weights: ``scripts/train_tiny_agent.py``'s
  ``train_checkpoint`` (~25 s here) trains the tiny agent; the JAX engine
  and the port's (its own safetensors and ``tokenizer.json`` readers) serve
  the checkpoint, the transcripts through ``tpu://`` and ``cuda://`` are
  equal, and the final answer is the memorized one.
- The port's own ``ChatClient`` on ``cuda://<name>`` answers as the
  installed ``ServingStack`` does, resolving the scheme lazily; the
  registry answers ``installed_stack_max_position`` for installed names
  only.
"""

import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opsagent_tpu.agent.react import assistant_with_config
from opsagent_tpu.llm import client as jclient
from opsagent_tpu.serving import api as japi
from opsagent_tpu.serving.engine import Engine as JaxEngine
from opsagent_tpu.serving.engine import EngineConfig as JaxEngineConfig
from opsagent_tpu.tools import ToolPrompt
from opsagent_tpu.tools.replay import NAMESPACES_SCRIPT, install_replay_kubectl
from opsagent_tpu_torch.llm import client as pclient
from opsagent_tpu_torch.models.config import TINY_TEST
from opsagent_tpu_torch.models.convert import params_from_jax
from opsagent_tpu_torch.models.llama import Llama
from opsagent_tpu_torch.serving import api as papi
from opsagent_tpu_torch.serving.engine import Engine, EngineConfig

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "scripts"))
try:
    import train_tiny_agent as tiny_agent
finally:
    sys.path.pop(0)

KW = dict(page_size=16, num_pages=512, max_pages_per_seq=64, max_batch_size=2)


@pytest.fixture(scope="module")
def stacks():
    jeng = JaxEngine(JaxEngineConfig(model="tiny-test", dtype=jnp.float32, tp=1,
                                     prefill_buckets=(128, 512), **KW))
    model = Llama(TINY_TEST, torch.float32, "cpu", seed=None)
    model.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, jeng.params),
                                          TINY_TEST))
    jstack = japi.ServingStack(jeng, restart_tolerant=False)
    pstack = papi.ServingStack(Engine(EngineConfig(model="tiny-test", dtype=torch.float32,
                                                   device="cpu", seed=0, **KW),
                                      model=model))
    japi.install_stack("tiny-jax", jstack)
    papi.install_stack("tiny-port", pstack)
    yield jstack, pstack
    japi.uninstall_stack("tiny-jax")
    papi.uninstall_stack("tiny-port")
    jstack.close()
    pstack.close()


def _agent(model, base_url=""):
    """The JAX agent loop on the tiny agent's system prompt and instruction,
    two iterations, 64 tokens a turn: (final reply, history)."""
    messages = [{"role": "system", "content": tiny_agent.SYS_PROMPT},
                {"role": "user",
                 "content": f"Here are the instructions: {tiny_agent.INSTRUCTION}"}]
    answer, history = assistant_with_config(model, messages, 64, False, False, 2, "",
                                            base_url)
    return answer, history


def test_agent_transcript_through_cuda_equals_tpu(stacks, monkeypatch, tmp_path):
    monkeypatch.setenv("OPSAGENT_CONVEYOR", "0")
    monkeypatch.setenv("PATH", os.environ["PATH"])
    install_replay_kubectl(NAMESPACES_SCRIPT, str(tmp_path / "bin"))
    monkeypatch.setitem(jclient._provider_factories, "cuda", papi._cuda_provider_factory)
    want = _agent("tpu://tiny-jax")
    got = _agent("cuda://tiny-port", base_url="tpu://")
    assert len(want[1]) >= 4                 # system, user and two turns at least
    assert got == want


def test_trained_agent_through_cuda_equals_tpu(monkeypatch, tmp_path):
    ckpt, tok_path, jcfg, loss, _ = tiny_agent.train_checkpoint(str(tmp_path / "ckpt"))
    assert loss < 0.05 and tok_path, f"the tiny agent did not memorize: loss {loss}"
    jstack = japi.ServingStack(JaxEngine(JaxEngineConfig(
        model="tiny-test", checkpoint=ckpt, tokenizer=tok_path, dtype=jnp.float32, tp=1,
        prefill_buckets=(128, 512, 1024), **KW), model_cfg=jcfg), restart_tolerant=False)
    pstack = papi.ServingStack(Engine(
        EngineConfig(model="tiny-test", checkpoint=ckpt, tokenizer=tok_path,
                     dtype=torch.float32, device="cpu", **KW),
        model_cfg=dataclasses.replace(TINY_TEST, vocab_size=jcfg.vocab_size)))
    japi.install_stack("tiny-agent", jstack)
    papi.install_stack("tiny-agent", pstack)
    monkeypatch.setenv("OPSAGENT_CONVEYOR", "0")
    monkeypatch.setenv("PATH", os.environ["PATH"])
    install_replay_kubectl(NAMESPACES_SCRIPT, str(tmp_path / "bin"))
    monkeypatch.setitem(jclient._provider_factories, "cuda", papi._cuda_provider_factory)
    try:
        want = _agent("tpu://tiny-agent")
        got = _agent("cuda://tiny-agent", base_url="tpu://")
    finally:
        japi.uninstall_stack("tiny-agent")
        papi.uninstall_stack("tiny-agent")
        jstack.close()
        pstack.close()
    assert got == want
    assert ToolPrompt.from_json(got[0]).final_answer == tiny_agent.FINAL_ANSWER
    assert any("kubectl" in str(m["content"]) for m in got[1])     # the tool ran


def test_port_client_answers_as_the_stack(stacks):
    _, pstack = stacks
    messages = [{"role": "user", "content": "list the pods"}]
    body = {"model": "tiny-port", "messages": messages, "max_tokens": 12,
            "temperature": 0}
    want = pstack.chat_completion(dict(body))
    got = pclient.ChatClient().chat_completion("cuda://tiny-port", messages,
                                               max_tokens=12, temperature=0)
    assert got["choices"] == want["choices"] and got["usage"] == want["usage"]
    assert got["model"] == "tiny-port"
    text = pclient.ChatClient().chat("cuda://tiny-port", 12, messages, temperature=0)
    assert text == want["choices"][0]["message"]["content"]


def test_scheme_table_and_registry(stacks):
    assert pclient._LAZY_SCHEME_MODULES == {"cuda": "opsagent_tpu_torch.serving.api"}
    assert pclient._resolve_scheme("cuda://tiny-port", "") == ("cuda", "tiny-port")
    assert pclient._resolve_scheme("gpt-4", "https://api.openai.com/v1") is None
    assert pclient._provider_factories["cuda"] is papi._cuda_provider_factory
    assert papi.installed_stack_max_position("tiny-port") == TINY_TEST.max_position
    assert papi.installed_stack_max_position("TINY-PORT") == TINY_TEST.max_position
    assert papi.installed_stack_max_position("never-installed") is None
    with pytest.raises(pclient.LLMError, match="no provider registered"):
        pclient.ChatClient().chat_completion("nosuch://x", [{"role": "user", "content": "x"}])
