"""The committed trained tiny agent (``tests/fixtures/tiny-agent-hf``) end to
end on the CPU, through both packages' own agent stacks.

``scripts/train_tiny_agent.py``'s ``train_checkpoint`` trained it (the
command and its final loss are in CHANGES.md) to memorize one two-turn
episode: ``count namespaces`` -> the kubectl call ``KUBECTL_CMD`` -> the
replay script's ``3`` -> ``FINAL_ANSWER``, under three system prompts: the
training script's own, the CLI's ``REACT_SYSTEM_PROMPT`` and the REST
server's ``EXECUTE_SYSTEM_PROMPT_CN``.

- The JAX package's agent through ``tpu://`` on the JAX engine, and the
  port's agent through ``cuda://`` on a CPU ``Engine`` (``device="cpu"``,
  installed with ``install_stack``), both with the host KV tier: equal
  transcripts and flight events (``tool_exec`` pairs with their
  ``parked_tokens``), with the conveyor on and with it off, and the
  memorized final answer; the JAX engine through the JAX agent gives it
  too (the fixture serves the JAX package as it is).
- The two REST servers' ``/api/execute`` over the same model give the same
  ``message``, the memorized answer.
- ``python -m opsagent_tpu_torch execute --model cuda://tiny-agent
  --checkpoint tests/fixtures/tiny-agent-hf`` exits 0 and prints it.
"""

import json
import os
import subprocess
import sys
import threading
import urllib.request

import jax.numpy as jnp
import pytest
import torch

from _torch_agent_kit import PKGS, flight_events, package, port_state  # noqa: F401
from opsagent_tpu.models.config import config_from_hf as jax_config_from_hf
from opsagent_tpu.serving import api as japi
from opsagent_tpu.serving.engine import Engine as JaxEngine
from opsagent_tpu.serving.engine import EngineConfig as JaxEngineConfig
from opsagent_tpu_torch.agent.prompts import EXECUTE_SYSTEM_PROMPT_CN, REACT_SYSTEM_PROMPT
from opsagent_tpu_torch.serving import api as papi
from opsagent_tpu_torch.serving.engine import Engine, EngineConfig
from opsagent_tpu_torch.tools.replay import NAMESPACES_SCRIPT, install_replay_kubectl

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "tests", "fixtures", "tiny-agent-hf")
sys.path.insert(0, os.path.join(REPO, "scripts"))
try:
    import train_tiny_agent as tiny_agent
finally:
    sys.path.pop(0)

NAME = "tiny-agent"
KW = dict(page_size=16, num_pages=512, max_pages_per_seq=96, max_batch_size=2, offload=True)


@pytest.fixture(scope="module")
def stacks():
    jstack = japi.ServingStack(JaxEngine(
        JaxEngineConfig(model="tiny-test", checkpoint=os.path.join(FIXTURE, "model.safetensors"),
                        tokenizer=FIXTURE, dtype=jnp.float32, tp=1,
                        prefill_buckets=(128, 512, 1024, 1536), **KW),
        model_cfg=jax_config_from_hf(FIXTURE)), restart_tolerant=False)
    pstack = papi.ServingStack(Engine(EngineConfig(
        model="auto", checkpoint=FIXTURE, tokenizer=FIXTURE, dtype=torch.float32,
        device="cpu", **KW)))
    japi.install_stack(NAME, jstack)
    papi.install_stack(NAME, pstack)
    yield jstack, pstack
    japi.uninstall_stack(NAME)
    papi.uninstall_stack(NAME)
    jstack.close()
    pstack.close()


@pytest.fixture
def replay(tmp_path, monkeypatch):
    """The replay kubectl first on PATH, refusing every command but the
    trained one (a refusal would change the transcript)."""
    monkeypatch.setenv("PATH", os.environ["PATH"])
    install_replay_kubectl(NAMESPACES_SCRIPT, str(tmp_path / "bin"))
    ran = []
    for n in PKGS:
        p = package(n)
        kubectl = p.tools.default_registry()["kubectl"]

        def only_trained(cmd, kubectl=kubectl, p=p):
            ran.append(cmd)
            if cmd != tiny_agent.KUBECTL_CMD:
                raise p.tools.ToolError(f"refused: {cmd}")
            return kubectl(cmd)

        monkeypatch.setitem(p.tools.copilot_tools, "kubectl", only_trained)
    return ran


def run_agent(pkg_name, conveyor, monkeypatch, system=tiny_agent.SYS_PROMPT,
              user=f"Here are the instructions: {tiny_agent.INSTRUCTION}"):
    p = package(pkg_name)
    monkeypatch.setenv("OPSAGENT_CONVEYOR", "1" if conveyor else "0")
    p.obs.flight.get_recorder().reset()
    messages = [{"role": "system", "content": system}, {"role": "user", "content": user}]
    answer, history = p.react.assistant_with_config(
        f"{p.scheme}://{NAME}", messages, 256, False, False, 4, "", "")
    return answer, history, flight_events(p, ("tool_exec",))


@pytest.mark.parametrize("conveyor", (True, False), ids=("conveyor", "blocking"))
def test_transcripts_equal_through_tpu_and_cuda(stacks, replay, monkeypatch, conveyor):
    want = run_agent("jax", conveyor, monkeypatch)
    got = run_agent("torch", conveyor, monkeypatch)
    assert got == want
    answer, history, events = got
    assert package("torch").tools.ToolPrompt.from_json(answer).final_answer == \
        tiny_agent.FINAL_ANSWER
    assert replay == [tiny_agent.KUBECTL_CMD] * 2
    assert [(e["phase"], e.get("conveyor", False)) for e in events] == [
        ("enter", conveyor), ("exit", conveyor)]
    # At tool entry the finished turn's pages park to host RAM; an early
    # launch parks while its turn still decodes, and a running sequence's
    # own pages stay.
    assert (events[0].get("parked_tokens", 0) > 0) == (not conveyor)


def test_conveyor_on_and_off_give_one_transcript(stacks, replay, monkeypatch):
    on = run_agent("torch", True, monkeypatch)
    off = run_agent("torch", False, monkeypatch)
    assert on[:2] == off[:2]


@pytest.mark.parametrize("system,user", (
    (REACT_SYSTEM_PROMPT, f"Here are the instructions: {tiny_agent.INSTRUCTION}"),
    (EXECUTE_SYSTEM_PROMPT_CN, tiny_agent.INSTRUCTION)), ids=("cli", "server"))
def test_trained_prompts_equal(stacks, replay, monkeypatch, system, user):
    want = run_agent("jax", True, monkeypatch, system, user)
    got = run_agent("torch", True, monkeypatch, system, user)
    assert got == want
    assert json.loads(got[0])["final_answer"] == tiny_agent.FINAL_ANSWER


def test_rest_servers_give_the_same_message(stacks, replay):
    import asyncio

    from aiohttp.test_utils import TestServer

    from opsagent_tpu.server.app import build_app
    from opsagent_tpu_torch.server.app import build_server
    from opsagent_tpu_torch.server.jwtauth import issue_token

    for n in PKGS:
        package(n).globalstore.set_global("jwtKey", "k")
    loop = asyncio.new_event_loop()
    thread = threading.Thread(target=loop.run_forever, daemon=True)
    thread.start()

    async def start():
        s = TestServer(build_app())
        await s.start_server()
        return s

    jserver = asyncio.run_coroutine_threadsafe(start(), loop).result(30)
    pserver = build_server("127.0.0.1", 0)
    threading.Thread(target=pserver.serve_forever, daemon=True).start()
    bases = {"jax": str(jserver.make_url("")).rstrip("/"),
             "torch": f"http://127.0.0.1:{pserver.server_address[1]}"}
    try:
        out = {}
        for n, scheme in (("jax", "tpu"), ("torch", "cuda")):
            req = urllib.request.Request(
                bases[n] + "/api/execute?show-thought=true", method="POST",
                data=json.dumps({"instructions": tiny_agent.INSTRUCTION,
                                 "currentModel": f"{scheme}://{NAME}"}).encode(),
                headers={"Authorization": f"Bearer {issue_token('admin', 'k')}",
                         "X-API-Key": "local", "Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=300) as r:
                out[n] = json.loads(r.read())
        for body in out.values():
            body.pop("request_id")
        assert out["torch"] == out["jax"]
        assert out["torch"]["message"] == tiny_agent.FINAL_ANSWER
        assert out["torch"]["tools_history"][0]["input"] == tiny_agent.KUBECTL_CMD
    finally:
        pserver.shutdown()
        pserver.server_close()
        asyncio.run_coroutine_threadsafe(jserver.close(), loop).result(30)
        loop.call_soon_threadsafe(loop.stop)


def test_cli_execute_prints_the_answer(tmp_path):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OPSAGENT_FLIGHT_DIR"] = str(tmp_path / "flight")
    env["PATH"] = install_replay_kubectl(NAMESPACES_SCRIPT, str(tmp_path / "bin")) + \
        os.pathsep + os.environ["PATH"]
    res = subprocess.run(
        [sys.executable, "-m", "opsagent_tpu_torch", "execute", "--no-reformat",
         "--model", f"cuda://{NAME}", "--checkpoint", FIXTURE, "--device", "cpu",
         "--max-tokens", "256", "--max-iterations", "4",
         tiny_agent.INSTRUCTION],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.strip() == tiny_agent.FINAL_ANSWER
