"""Shared pieces of the agent stack's parity tests (``tests/test_torch_agent*.py``,
``test_torch_tools.py``, ``test_torch_k8s.py``): each package's agent modules
under one name, a scripted chat provider registered with either package's
client, and the resets of the port's process-wide state (tests/conftest.py
resets only the JAX package's).
"""

import copy
import types

import pytest

from opsagent_tpu.llm import tokens as jtokens

PKGS = ("jax", "torch")


def package(name: str) -> types.SimpleNamespace:
    """The agent modules of ``name`` ("jax": opsagent_tpu, "torch": the
    port) and its in-process scheme."""
    if name == "jax":
        from opsagent_tpu import obs, tools, workflows
        from opsagent_tpu.agent import conveyor, funcall, react
        from opsagent_tpu.llm import client, tokens
        from opsagent_tpu.serving import faults
        from opsagent_tpu.tools import proc, replay
        from opsagent_tpu.utils import globalstore, perf

        scheme = "tpu"
    else:
        from opsagent_tpu_torch import obs, tools, workflows
        from opsagent_tpu_torch.agent import conveyor, funcall, react
        from opsagent_tpu_torch.llm import client, tokens
        from opsagent_tpu_torch.serving import faults
        from opsagent_tpu_torch.tools import proc, replay
        from opsagent_tpu_torch.utils import globalstore, perf

        scheme = "cuda"
    return types.SimpleNamespace(
        name=name, obs=obs, tools=tools, workflows=workflows, conveyor=conveyor,
        funcall=funcall, react=react, client=client, tokens=tokens, faults=faults,
        proc=proc, replay=replay, globalstore=globalstore, perf=perf, scheme=scheme,
    )


class ScriptedLLM:
    """A scripted chat provider: pops one canned reply per request (a string
    of assistant content, a full assistant message dict, or a callable of
    the request body)."""

    def __init__(self, replies):
        self.replies = list(replies)
        self.requests = []

    def __call__(self, body):
        self.requests.append(copy.deepcopy(body))
        if not self.replies:
            raise AssertionError("ScriptedLLM ran out of replies")
        r = self.replies.pop(0)
        if callable(r):
            r = r(body)
        message = r if isinstance(r, dict) else {"role": "assistant", "content": r}
        return {
            "id": "fake",
            "object": "chat.completion",
            "choices": [{"index": 0, "message": message, "finish_reason": "stop"}],
            "usage": {},
        }


def reset_port():
    """The port's process-wide state: obs, perf, faults, the global store."""
    p = package("torch")
    p.obs.get_registry().reset()
    p.obs.get_store().clear()
    p.obs.flight.get_recorder().reset()
    p.obs.flight.reset_compile_watchdog()
    p.obs.slo.get_watchdog().reset()
    p.obs.history.reset()
    p.obs.trace.reset_retention()
    p.perf.get_perf_stats().reset()
    p.faults.reset()
    p.globalstore.clear_globals()


@pytest.fixture(autouse=True)
def port_state(tmp_path, monkeypatch):
    """Fresh port state around each test; both packages count text at four
    characters a token (JAX's ``tiktoken`` encoding off), anomaly dumps in
    the test's directory."""
    monkeypatch.setenv("OPSAGENT_FLIGHT_DIR", str(tmp_path / "flight"))
    monkeypatch.setattr(jtokens, "_encoding", lambda name="cl100k_base": None)
    reset_port()
    yield
    reset_port()


@pytest.fixture
def registries():
    """``install(pkg, mapping)`` replaces a package's tool registry; every
    registry and the ``fake`` scheme come back afterwards."""
    saved = {n: dict(package(n).tools.copilot_tools) for n in PKGS}

    def install(pkg, mapping):
        pkg.tools.copilot_tools.clear()
        pkg.tools.copilot_tools.update(mapping)
        return mapping

    yield install
    for n in PKGS:
        reg = package(n).tools.copilot_tools
        reg.clear()
        reg.update(saved[n])
        package(n).client._provider_factories.pop("fake", None)


def script(pkg, replies) -> ScriptedLLM:
    """Register a ScriptedLLM under ``fake://`` with ``pkg``'s client."""
    fake = ScriptedLLM(replies)
    pkg.client.register_provider("fake", lambda target: fake)
    return fake


TIMING = {"ts", "wall", "id", "duration_ms", "launch_offset_ms", "overlap_ms", "request_id"}


def flight_events(pkg, kinds=("tool_exec", "fault_injected")) -> list[dict]:
    """The ring's events of ``kinds`` without their clocks and ids."""
    return [{k: v for k, v in e.items() if k not in TIMING}
            for e in pkg.obs.flight.get_recorder().snapshot() if e.get("kind") in kinds]
