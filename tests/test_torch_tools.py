"""The port's tool layer, token accounting and fault grammar against the JAX
package's, on the CPU.

- The tool modules (``tools/kubectl.py`` through the replay ``kubectl``,
  ``python_tool``, ``trivy`` and ``jq`` without their binaries, ``search``
  without credentials), ``ToolPrompt`` and the registry: equal results and
  equal errors.
- ``tools/proc.py``: output capture, stdin, a timeout and a cancel kill the
  whole process group, in both packages.
- ``llm/tokens.py`` with JAX's ``tiktoken`` encoding off (both count four
  characters a token): counting, ``constrict_messages`` /
  ``constrict_prompt``, and ``get_token_limits`` for ``cuda://<name>``
  against JAX's for ``tpu://<name>`` on the same installed stacks.
- ``serving/faults.py``: the same specs fire on the same hits.
"""

import os
import subprocess
import sys
import time
import types

import pytest

from _torch_agent_kit import PKGS, package, port_state  # noqa: F401


@pytest.fixture(params=PKGS)
def pkg(request):
    return package(request.param)


def both(fn):
    """fn(pkg) for each package: {"jax": ..., "torch": ...}, an exception
    as its (type name, message)."""
    out = {}
    for n in PKGS:
        try:
            out[n] = fn(package(n))
        except Exception as e:  # noqa: BLE001 - compared across packages
            out[n] = (type(e).__name__, str(e))
    return out


def same(fn):
    got = both(fn)
    assert got["torch"] == got["jax"]
    return got["jax"]


# -- tool modules ---------------------------------------------------------------

@pytest.fixture
def replay_path(tmp_path, monkeypatch):
    """The trained agent's replay kubectl first on PATH (both packages'
    scripts are the same bytes)."""
    assert package("torch").replay.NAMESPACES_SCRIPT == package("jax").replay.NAMESPACES_SCRIPT
    assert package("torch").replay.CLUSTER_SCRIPT == package("jax").replay.CLUSTER_SCRIPT
    assert package("torch").replay.MULTI_TASK_SCRIPT == package("jax").replay.MULTI_TASK_SCRIPT
    monkeypatch.setenv("PATH", os.environ["PATH"])
    return package("torch").replay.install_replay_kubectl(
        package("torch").replay.CLUSTER_SCRIPT, str(tmp_path / "bin"))


KUBECTL_INPUTS = ("kubectl get namespaces --no-headers | wc -l", "get pods", "describe frob",
                  "kubectl get namespaces | head -2")


@pytest.mark.parametrize("cmd", KUBECTL_INPUTS)
def test_kubectl_through_the_replay_script(cmd, replay_path):
    from opsagent_tpu_torch.tools import kubectl as pk

    res = same(lambda p: __import__(f"{p.tools.__name__}.kubectl", fromlist=["kubectl"])
               .kubectl(cmd))
    if cmd == "describe frob":
        assert res[0] == "ToolError" and "no canned output" in res[1]
    else:
        assert isinstance(res, str) and res
    assert pk._classify(cmd) == __import__("opsagent_tpu.tools.kubectl", fromlist=["x"])\
        ._classify(cmd)


def test_kubectl_noise_filter_and_verbs():
    from opsagent_tpu.tools import kubectl as jk
    from opsagent_tpu_torch.tools import kubectl as pk

    noisy = ("E0307 12:34:56.789 memcache.go:265] couldn't get current server API group list\n"
             "NAME   READY\nweb-1  1/1\n"
             "W0101 00:00:00.1 metrics.k8s.io/v1beta1 error\n")
    assert pk.filter_noise(noisy) == jk.filter_noise(noisy) == "NAME   READY\nweb-1  1/1"
    for cmd in ("kubectl -n x logs pod", "get pods", "kubectl top nodes", "helm list",
                "kubectl --context a apply -f x"):
        assert pk._classify(cmd) == jk._classify(cmd)


PY_SCRIPTS = ("print(21 * 2)", "raise RuntimeError('boom')",
              """print('he said "hi"; $(ls)')""", "import sys; sys.stdout.write('')")


@pytest.mark.parametrize("script", PY_SCRIPTS)
def test_python_tool(script):
    res = same(lambda p: __import__(f"{p.tools.__name__}.python_tool", fromlist=["x"])
               .python_repl(script))
    if "boom" in script:
        assert res[0] == "ToolError" and "boom" in res[1]
    elif "21" in script:
        assert res == "42"


@pytest.mark.parametrize("inp", ('{"a": {"b": [1, 2]}} | .a.b[1]',
                                 '{"items": [{"m": {"n": "x"}}, {"m": {"n": "y"}}]} | .items[].m.n',
                                 '[1, 2, 3] | length', '{"a": 1} | .b', '{not json} | .a',
                                 'no pipe here'))
def test_jq_tool(inp, monkeypatch):
    monkeypatch.setenv("PATH", "/nonexistent")        # the built-in evaluator
    same(lambda p: __import__(f"{p.tools.__name__}.jq", fromlist=["x"]).jq(inp))


def test_trivy_and_search_without_their_backends(monkeypatch):
    monkeypatch.setenv("PATH", "/nonexistent")
    monkeypatch.delenv("GOOGLE_API_KEY", raising=False)
    for image in ("image nginx:1.25", "", "alpine"):
        res = same(lambda p: __import__(f"{p.tools.__name__}.trivy", fromlist=["x"])
                   .trivy(image))
        assert res[0] == "ToolError"
    res = same(lambda p: __import__(f"{p.tools.__name__}.search", fromlist=["x"])
               .google_search("k8s"))
    assert res[0] == "ToolError" and "GOOGLE_API_KEY" in res[1]


@pytest.mark.parametrize("text", (
    '{"question": "q", "thought": "t", "action": {"name": "kubectl", "input": "get ns"}, '
    '"observation": "", "final_answer": ""}',
    '{"action": "kubectl", "thought": "t"}',
    '```json\n{"thought": "multi\nline", "final_answer": "done",}\n```',
    '{"action": {"name": "jq", "input": {"a": 1}}, "observation": 3}',
    'not json at all'))
def test_toolprompt_parse_and_wire_form(text):
    same(lambda p: p.tools.ToolPrompt.from_json(text).to_json())


def test_registry_names():
    got = both(lambda p: sorted(p.tools.default_registry()))
    assert got["torch"] == got["jax"] == ["jq", "kubectl", "python", "search", "trivy"]


# -- proc -----------------------------------------------------------------------

def test_proc_run_contract(pkg):
    r = pkg.proc.run([sys.executable, "-c",
                      "print('out'); import sys; print('err', file=sys.stderr)"])
    assert (r.returncode, r.stdout.strip(), r.stderr.strip()) == (0, "out", "err")
    r = pkg.proc.run([sys.executable, "-c", "import sys; print(sys.stdin.read().upper())"],
                     input_text="hello")
    assert r.stdout.strip() == "HELLO"
    with pytest.raises(FileNotFoundError):
        pkg.proc.run(["no-such-binary-anywhere"])


def _group_gone(pid: int, within: float = 3.0) -> bool:
    deadline = time.monotonic() + within
    while time.monotonic() < deadline:
        try:
            os.killpg(pid, 0)
        except ProcessLookupError:
            return True
        time.sleep(0.05)
    return False


def test_proc_timeout_kills_whole_group(pkg):
    t0 = time.perf_counter()
    p = pkg.proc.ToolProcess(["bash", "-c", "sleep 30 & echo started; wait"], timeout=0.3)
    with pytest.raises(subprocess.TimeoutExpired):
        p.result()
    assert time.perf_counter() - t0 < 10.0 and p.timed_out
    assert _group_gone(p.proc.pid), "process group survived the timeout kill"


def test_proc_cancel_kills_whole_group(pkg):
    procs = []
    with pkg.proc.cancel_scope(procs):
        p = pkg.proc.ToolProcess(["bash", "-c", "sleep 30 & sleep 30 & wait"])
    assert procs == [p]
    p.cancel()
    assert p.wait(5.0) and p.cancelled
    assert _group_gone(p.proc.pid), "process group survived the cancel"


# -- tokens -----------------------------------------------------------------------

TEXTS = ("", "a", "count the namespaces", "x" * 4097, "多字节文本" * 9)


def test_counting_equal():
    for t in TEXTS:
        assert same(lambda p: p.tokens.count_tokens(t)) == max(1, len(t) // 4)
    messages = [{"role": "system", "content": "s" * 40},
                {"role": "user", "content": "u" * 400, "name": "ops"},
                {"role": "assistant", "content": None, "tool_calls": [{"id": "1"}]}]
    same(lambda p: p.tokens.num_tokens_from_messages(messages))


@pytest.mark.parametrize("model,budget", (("gpt-4", 8000), ("gpt-4", 100), ("qwen-plus", 0),
                                          ("unknown", 4000)))
def test_constrict_messages_equal(model, budget):
    messages = [{"role": "system", "content": "rules " * 200}] + [
        {"role": "user" if i % 2 == 0 else "assistant", "content": f"turn {i} " * 300}
        for i in range(12)]
    out = same(lambda p: p.tokens.constrict_messages(messages, model, budget))
    assert out[0]["role"] == "system" and out[-1] == messages[-1]


@pytest.mark.parametrize("limit", (0, 100, 1024, 100000))
def test_constrict_prompt_equal(limit):
    for text in ("\n".join(f"pod-{i} Running" for i in range(3000)), "y" * 50000):
        same(lambda p: p.tokens.constrict_prompt(text, limit))


def test_constrict_prompt_ends_on_two_long_lines():
    # The JAX package's loop keeps both of two lines (2 // 3 == 0) and never
    # ends on this input; the port drops the first.
    from opsagent_tpu_torch.llm.tokens import constrict_prompt

    out = constrict_prompt("a" * 5000 + "\n" + "b" * 5000, 1024)
    assert out == "b" * 3332          # then two thirds of the last line


def test_token_limits_cuda_equal_tpu_on_the_same_stacks():
    from opsagent_tpu.serving import api as japi
    from opsagent_tpu_torch.serving import api as papi

    def fake_stack(max_position):
        return types.SimpleNamespace(engine=types.SimpleNamespace(
            model_cfg=types.SimpleNamespace(max_position=max_position)))

    stacks = {"Tiny-Agent": 16384, "real": 4096}
    for name, mp in stacks.items():
        japi.install_stack(name, fake_stack(mp))
        papi.install_stack(name, fake_stack(mp))
    try:
        for name in ("tiny-agent", "TINY-AGENT", "real", "bench-8b", "tiny-test",
                     "qwen2.5-7b-instruct", "never-installed"):
            want = package("jax").tokens.get_token_limits(f"tpu://{name}")
            assert package("torch").tokens.get_token_limits(f"cuda://{name}") == want
        assert package("torch").tokens.get_token_limits("cuda://tiny-agent") == 16384
    finally:
        for name in stacks:
            japi.uninstall_stack(name)
            papi.uninstall_stack(name)
    for model in ("gpt-4o-mini", "gpt-4", "qwen2.5-72b", "deepseek-chat", "llama3-8b", "x"):
        same(lambda p: p.tokens.get_token_limits(model))


# -- fault grammar ----------------------------------------------------------------

SPECS = ("tool.exec@1", "tool.timeout@2", "tool.exec@2..4", "tool.exec@3+",
         "tool.exec@every:3", "tool.exec@p:0.5:7", "tool.exec@1;tool.timeout@every:2",
         "tool.exec@bogus;tool.timeout@1", "", "tool.exec@1\ntool.exec@5")


@pytest.mark.parametrize("spec", SPECS)
def test_fault_specs_fire_on_the_same_hits(spec):
    def run(p):
        p.faults.configure(spec)
        try:
            fired = [(point, p.faults.fire(point, tool="kubectl"))
                     for _ in range(12) for point in ("tool.exec", "tool.timeout")]
            return fired, p.faults.summary(), [
                (e["point"], e["hit"]) for e in p.obs.flight.get_recorder().snapshot()
                if e["kind"] == "fault_injected"]
        finally:
            p.faults.reset()

    same(run)


def test_fault_spec_from_the_environment_and_maybe_raise(monkeypatch):
    monkeypatch.setenv("OPSAGENT_FAULTS", "tool.timeout@2")

    def run(p):
        p.faults.reset()
        out = []
        for _ in range(3):
            try:
                p.faults.maybe_raise("tool.timeout", TimeoutError, "injected", tool="x")
                out.append("ok")
            except TimeoutError as e:
                out.append(str(e))
        p.faults.reset()
        return out, p.obs.FAULT_INJECTIONS.value(point="tool.timeout")

    assert same(run) == (["ok", "injected", "ok"], 1.0)
