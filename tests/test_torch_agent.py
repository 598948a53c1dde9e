"""The port's agent loops (``opsagent_tpu_torch/agent``: the ReAct loop, its
conveyor, the function-calling loop and the workflows) against the JAX
package's, on the CPU.

Every case of tests/test_react.py, test_conveyor.py and test_funcall.py runs
through both packages' loops, with the same scripted replies and tool
doubles (``_torch_agent_kit``): each case's own checks hold for each
package (``[jax]`` / ``[torch]``), and the ``..._equal`` twin runs both and
holds the return values, the transcripts, the requests the model saw and
the flight events (``tool_exec`` enter and exit with their outcomes and
errors, ``fault_injected``) equal. The fault specs ``tool.exec@1`` and
``tool.timeout@2`` give equal observations on both the blocking and the
conveyor path.
"""

import json
import os
import subprocess
import sys
import time

import pytest

from _torch_agent_kit import PKGS, flight_events, package, port_state, registries, script  # noqa: F401


def tp(thought="", name="", input="", observation="", final=""):
    return json.dumps({
        "question": "q",
        "thought": thought,
        "action": {"name": name, "input": input},
        "observation": observation,
        "final_answer": final,
    })


def msgs(instr="count the namespaces"):
    return [
        {"role": "system", "content": "you are a test agent"},
        {"role": "user", "content": instr},
    ]


@pytest.fixture(params=PKGS)
def pkg(request):
    return package(request.param)


# -- ReAct loop: tests/test_react.py's cases --------------------------------

def _tool_error(p):
    def broken(cmd):
        raise p.tools.ToolError("connection refused")
    return broken


HUGE = "\n".join(f"pod-{i} Running" for i in range(20000))

# name -> (replies, tools(pkg, calls), assistant kwargs)
REACT_CASES = {
    "happy_path_tool_then_final": (
        [tp(thought="list them", name="kubectl", input="get ns --no-headers"),
         tp(thought="done", observation="default\nkube-system\nkube-public",
            final="There are 3 namespaces in the cluster.")],
        lambda p, calls: {"kubectl": lambda c: (calls.append(c),
                                                "default\nkube-system\nkube-public")[1]},
        {}),
    "unparseable_first_reply_is_final_answer": (
        ["Just a plain prose answer with no JSON."], lambda p, calls: {}, {}),
    "template_final_answer_rejected": (
        [tp(name="kubectl", input="get ns", final="<final_answer>"),
         tp(observation="real data here", final="A real answer with enough length.")],
        lambda p, calls: {"kubectl": lambda c: "real data here"}, {}),
    "tool_error_becomes_observation": (
        [tp(name="kubectl", input="get pods"),
         tp(observation="noted the failure",
            final="Could not reach the cluster: connection refused.")],
        lambda p, calls: {"kubectl": _tool_error(p)}, {}),
    "unknown_tool_observation": (
        [tp(name="helm", input="list"),
         tp(observation="ok", final="Helm is not one of my tools, sorry.")],
        lambda p, calls: {}, {}),
    "mid_loop_unparseable_triggers_summarize": (
        [tp(name="kubectl", input="get ns"), "suddenly plain prose, not JSON",
         json.dumps({"final_answer": "Summarized: there are 3 namespaces."})],
        lambda p, calls: {"kubectl": lambda c: "data"}, {}),
    "iteration_cap": (
        [tp(name="kubectl", input="get ns")] * 4,
        lambda p, calls: {"kubectl": lambda c: "data"}, {"max_iterations": 3}),
    "observation_truncated": (
        [tp(name="kubectl", input="get pods -A"),
         tp(observation="tail", final="Way too many pods to list fully.")],
        lambda p, calls: {"kubectl": lambda c: HUGE}, {}),
    "empty_action_asks_for_one": (
        [tp(thought="hmm"), tp(observation="x", final="Nothing needed doing after all.")],
        lambda p, calls: {}, {}),
}


def run_react_case(p, name, registries):
    replies, tools, kw = REACT_CASES[name]
    calls = []
    registries(p, tools(p, calls))
    fake = script(p, replies)
    out, history = p.react.assistant_with_config("fake://m", msgs(), **kw)
    return out, history, fake, calls


def check_react_case(p, name, out, history, fake, calls):
    fed = [r["messages"][-1]["content"] for r in fake.requests]
    if name == "happy_path_tool_then_final":
        assert p.tools.ToolPrompt.from_json(out).final_answer == \
            "There are 3 namespaces in the cluster."
        assert calls == ["get ns --no-headers"]
        assert any("kube-public" in m["content"] for m in history if m["role"] == "user")
    elif name == "unparseable_first_reply_is_final_answer":
        assert out == "Just a plain prose answer with no JSON."
    elif name == "template_final_answer_rejected":
        assert "A real answer with enough length." in out
    elif name == "tool_error_becomes_observation":
        assert "connection refused" in out
        assert "Tool kubectl failed with error" in fed[1] and "connection refused" in fed[1]
    elif name == "unknown_tool_observation":
        assert "Tool helm is not available" in fed[1]
    elif name == "mid_loop_unparseable_triggers_summarize":
        assert out == "Summarized: there are 3 namespaces."
        assert "Summarize" in fed[2]
    elif name == "iteration_cap":
        assert isinstance(out, str) and len(fake.requests) == 4
    elif name == "observation_truncated":
        assert p.tokens.count_tokens(fed[1]) < 1400
        assert "pod-19999" in fed[1]
    elif name == "empty_action_asks_for_one":
        assert "No action was specified" in fed[1]


@pytest.mark.parametrize("name", sorted(REACT_CASES))
def test_react_case(pkg, name, registries):
    out, history, fake, calls = run_react_case(pkg, name, registries)
    check_react_case(pkg, name, out, history, fake, calls)


@pytest.mark.parametrize("name", sorted(REACT_CASES))
def test_react_case_equal(name, registries):
    got = {}
    for n in PKGS:
        p = package(n)
        out, history, fake, calls = run_react_case(p, name, registries)
        got[n] = (out, history, fake.requests, calls, flight_events(p))
    assert got["torch"] == got["jax"]


@pytest.mark.parametrize("pkg_name", PKGS)
def test_is_template_value(pkg_name):
    f = package(pkg_name).react.is_template_value
    assert f("") and f("<final_answer>") and f("short")
    assert f("answer with <placeholder> inside")
    assert not f("There are 3 namespaces in this cluster.")


# -- fault injection on the tool path ----------------------------------------

FAULT_SPECS = ("tool.exec@1", "tool.timeout@2")


def run_fault_case(p, spec, conveyor_on, registries, monkeypatch):
    """Three tool turns under ``spec``; the blocking path through the
    scripted provider, or the conveyor through a scripted stream."""
    replies = [tp(name="kubectl", input=f"get ns {i}") for i in range(3)] + [
        tp(observation="seen", final="Enough evidence gathered, done.")]
    registries(p, {"kubectl": lambda c: f"ran {c}"})
    p.faults.configure(spec)
    if conveyor_on:
        monkeypatch.setenv("OPSAGENT_CONVEYOR", "1")
        monkeypatch.setattr(p.conveyor, "stream_constrained_turn", _fake_stream(list(replies)))
        monkeypatch.setattr(p.client.ChatClient, "chat", _fake_chat([]))
        out, history = p.react.assistant_with_config(
            f"{p.scheme}://convey-test", msgs(), 256, False, False, 6, "", "")
    else:
        script(p, replies)
        out, history = p.react.assistant_with_config("fake://m", msgs(), max_iterations=6)
    return out, history, flight_events(p)


@pytest.mark.parametrize("conveyor_on", (False, True), ids=("blocking", "conveyor"))
@pytest.mark.parametrize("spec", FAULT_SPECS)
def test_fault_specs_give_equal_observations(spec, conveyor_on, registries, monkeypatch):
    got = {}
    for n in PKGS:
        p = package(n)
        got[n] = run_fault_case(p, spec, conveyor_on, registries, monkeypatch)
        p.faults.reset()
    out, history, events = got["torch"]
    assert got["torch"] == got["jax"]
    observations = [json.loads(m["content"])["observation"] for m in history
                    if m["role"] == "user" and m["content"].startswith("{")]
    point = spec.split("@")[0]
    assert [e["point"] for e in events if e["kind"] == "fault_injected"] == [point]
    failed = [o for o in observations if not o.startswith("ran get ns")]
    if conveyor_on:
        # The early launch died; the blocking relaunch ran the tool.
        assert failed == []
        assert [e["error"] for e in events if e.get("outcome") == "error"] == [
            f"injected tool subprocess {'failure' if point == 'tool.exec' else 'timeout'}"]
    else:
        hit = 0 if spec == "tool.exec@1" else 1
        assert failed == [observations[hit]]
        assert "injected tool subprocess" in failed[0]


# -- conveyor: tests/test_conveyor.py's cases ---------------------------------

def tp_json(name="kubectl", tool_input="kubectl get ns", observation="", final=""):
    """A wire-order ToolPrompt reply like the constrained decode emits."""
    return json.dumps({
        "question": "how many namespaces?",
        "thought": "count them",
        "action": {"name": name, "input": tool_input},
        "observation": observation,
        "final_answer": final,
    })


def tool_events(p):
    return [e for e in p.obs.flight.get_recorder().snapshot() if e.get("kind") == "tool_exec"]


def schema(p):
    if p.name == "jax":
        from opsagent_tpu.serving.constrained import TOOLPROMPT_SCHEMA
    else:
        from opsagent_tpu_torch.serving.constrained import TOOLPROMPT_SCHEMA
    return TOOLPROMPT_SCHEMA


def test_toolprompt_schemas_are_equal():
    assert schema(package("torch")) == schema(package("jax"))


def test_call_path_of_toolprompt_schema(pkg):
    cp = pkg.conveyor._call_path
    assert cp(schema(pkg)) == ("action",)
    assert cp(None) == ("action",)
    assert cp({"properties": {"invoke": {
        "type": "object", "properties": {"name": {}, "input": {}},
    }}}) == ("invoke",)


def _events(p, text, chunk):
    parser = p.conveyor.StreamParser(schema(p))
    out = []
    for i in range(0, len(text), chunk):
        out.extend(parser.feed(text[i:i + chunk]))
    return [(e.kind, e.path, e.field, e.value) for e in out]


PARSER_TEXTS = (
    tp_json(),
    tp_json(tool_input='get pods -o jsonpath="{.items}" \\ tail'),
    tp_json(tool_input='echo "hi"'),
    '{"n": 42, "ok": true, "call": {"name": "jq", "depth": 3}, "arr": [1, 2]}',
)


@pytest.mark.parametrize("chunk", (1, 2, 3, 7, 64))
def test_parser_events_equal_any_chunking(chunk):
    for text in PARSER_TEXTS:
        want = _events(package("jax"), text, chunk)
        assert _events(package("torch"), text, chunk) == want
        assert want == _events(package("jax"), text, len(text))


def test_parser_event_order_char_by_char(pkg):
    kinds = [(k, f) for k, _, f, _ in _events(pkg, tp_json(), 1)]
    assert kinds == [
        ("field_closed", "question"), ("field_closed", "thought"),
        ("tool_name_closed", "name"), ("arg_closed", "input"),
        ("field_closed", ""), ("field_closed", "observation"),
        ("field_closed", "final_answer"), ("call_closed", ""),
    ]


def test_parser_escaped_quote_split_across_deltas(pkg):
    p = pkg.conveyor.StreamParser(schema(pkg))
    text = tp_json(tool_input='echo "hi"')
    cut = text.index('\\"') + 1
    events = p.feed(text[:cut]) + p.feed(text[cut:])
    assert [e.value for e in events if e.kind == "arg_closed"] == ['echo "hi"']


def test_parser_ignores_bytes_after_root_close(pkg):
    p = pkg.conveyor.StreamParser(schema(pkg))
    assert p.feed(tp_json())[-1].kind == "call_closed"
    assert p.feed('{"question": "again"}') == []


def test_launch_ready_matches_tool_module_declarations(pkg):
    import importlib

    base = "opsagent_tpu.tools" if pkg.name == "jax" else "opsagent_tpu_torch.tools"
    for name, mod in (("kubectl", "kubectl"), ("python", "python_tool"),
                      ("trivy", "trivy"), ("jq", "jq")):
        fields = importlib.import_module(f"{base}.{mod}").LAUNCH_FIELDS
        assert pkg.tools.LAUNCH_READY[name] == fields
        assert pkg.tools.launch_ready_fields(name) == fields
    for name in list(pkg.tools.LAUNCH_READY) + ["unknown-tool"]:
        assert pkg.tools.wire_fields_for(name) == frozenset({"input"})
    assert pkg.tools.launch_ready_fields("unknown-tool") == ("input",)
    assert package("torch").tools.LAUNCH_READY == package("jax").tools.LAUNCH_READY


def test_tool_launch_result_errors_and_matches(pkg):
    launch = pkg.conveyor.ToolLaunch("kubectl", "get ns", lambda s: f"ran:{s}")
    assert launch.result() == "ran:get ns"
    assert launch.done() and launch.t_done is not None
    assert launch.matches("kubectl", "get ns")
    assert not launch.matches("kubectl", "get pods") and not launch.matches("jq", "get ns")

    def boom(s):
        raise pkg.tools.ToolError("kubectl not reachable")

    launch = pkg.conveyor.ToolLaunch("kubectl", "get ns", boom)
    launch.wait(5.0)
    assert isinstance(launch.error(), pkg.tools.ToolError)
    with pytest.raises(pkg.tools.ToolError, match="not reachable"):
        launch.result()


def test_tool_launch_fault_points_fire_in_worker(pkg):
    for spec, exc in (("tool.exec@1", pkg.tools.ToolError), ("tool.timeout@1", TimeoutError)):
        pkg.faults.configure(spec)
        try:
            launch = pkg.conveyor.ToolLaunch("kubectl", "get ns", lambda s: "ok")
            with pytest.raises(exc):
                launch.result()
        finally:
            pkg.faults.reset()


def test_tool_launch_cancel_reaps_subprocess(pkg):
    def slow_tool(s):
        return pkg.proc.run(["sleep", "30"]).stdout

    launch = pkg.conveyor.ToolLaunch("python", "irrelevant", slow_tool)
    deadline = time.monotonic() + 3.0
    while not launch._procs and time.monotonic() < deadline:
        time.sleep(0.01)
    assert launch._procs, "worker never spawned its subprocess"
    pid = launch._procs[0].proc.pid
    launch.cancel()
    assert launch.wait(10.0) and launch.cancelled
    with pytest.raises(ProcessLookupError):
        os.killpg(pid, 0)


def test_turn_conveyor_launches_before_call_closes(pkg):
    ran = []

    def kubectl(s):
        ran.append(s)
        return "3 namespaces"

    turn = pkg.conveyor.TurnConveyor({"kubectl": kubectl}, schema=schema(pkg))
    text = tp_json()
    cut = text.index('"observation"')
    turn.on_delta(text[:cut])
    assert turn.launch is not None and turn.launch.input == "kubectl get ns"
    assert pkg.obs.TOOL_EARLY_LAUNCHES.value(tool="kubectl") == 1.0
    turn.on_delta(text[cut:])
    turn.finish_stream()
    assert turn.launch.result() == "3 namespaces" and ran == ["kubectl get ns"]
    enter = tool_events(pkg)[0]
    assert enter["phase"] == "enter" and enter["conveyor"] is True
    assert enter["launch_offset_ms"] >= 0.0
    assert "opsagent_tool_launch_lead_seconds" in pkg.obs.metrics_text()


def test_turn_conveyor_ignores_unknown_tool_and_missing_fields(pkg):
    turn = pkg.conveyor.TurnConveyor({"kubectl": lambda s: "ok"}, schema=schema(pkg))
    turn.on_delta(tp_json(name="not-a-tool"))
    assert turn.launch is None
    turn2 = pkg.conveyor.TurnConveyor({"kubectl": lambda s: "ok"}, schema=schema(pkg))
    text = tp_json()
    turn2.on_delta(text[:text.index('"input"')])
    assert turn2.launch is None


def test_turn_conveyor_abort_records_cancelled_exit(pkg):
    turn = pkg.conveyor.TurnConveyor({"kubectl": lambda s: "ok"}, schema=schema(pkg))
    text = tp_json()
    turn.on_delta(text[:text.index('"observation"')])
    turn.abort()
    evs = tool_events(pkg)
    assert [e["phase"] for e in evs] == ["enter", "exit"]
    assert evs[1]["outcome"] == "cancelled" and evs[1]["conveyor"] is True


def _fake_stream(replies, chunk=7, delay_s=0.003):
    """Stand-in for conveyor.stream_constrained_turn: each scripted reply
    through on_delta in small paced chunks."""
    it = iter(replies)

    def fake(model, max_tokens, messages, response_format, on_delta):
        text = next(it)
        for i in range(0, len(text), chunk):
            on_delta(text[i:i + chunk])
            time.sleep(delay_s)
        return text

    return fake


def _fake_chat(replies):
    it = iter(replies)

    def fake(self, model, max_tokens, messages, **kw):
        return next(it)

    return fake


def _scripted_replies():
    return [tp_json(), tp_json(name="", tool_input="", observation="3",
                               final="There are 3 namespaces in the cluster.")]


def _run_react(p, monkeypatch, registries, replies, conveyor_on, tool):
    monkeypatch.setenv("OPSAGENT_CONVEYOR", "1" if conveyor_on else "0")
    registries(p, {"kubectl": tool})
    if conveyor_on:
        monkeypatch.setattr(p.conveyor, "stream_constrained_turn", _fake_stream(replies))
    else:
        monkeypatch.setattr(p.client.ChatClient, "chat", _fake_chat(replies))
    return p.react.assistant_with_config(
        f"{p.scheme}://convey-test", msgs("count namespaces"), 256, False, False, 4, "", "")


def _slow_kubectl(s):
    time.sleep(0.12)
    return "namespace-a\nnamespace-b\nnamespace-c"


def test_react_conveyor_transcripts_identical_on_vs_off(pkg, monkeypatch, registries):
    out_on, hist_on = _run_react(pkg, monkeypatch, registries, _scripted_replies(), True,
                                 _slow_kubectl)
    assert pkg.obs.TOOL_EARLY_LAUNCHES.value(tool="kubectl") == 1.0
    assert pkg.obs.TOOL_OVERLAP_SECONDS.value() > 0.0
    evs = tool_events(pkg)
    assert [e["phase"] for e in evs] == ["enter", "exit"]
    assert evs[1]["outcome"] == "ok" and evs[1]["overlap_ms"] > 0.0
    out_off, hist_off = _run_react(pkg, monkeypatch, registries, _scripted_replies(), False,
                                   _slow_kubectl)
    assert pkg.obs.TOOL_EARLY_LAUNCHES.value(tool="kubectl") == 1.0
    assert out_on == out_off and hist_on == hist_off
    assert "3 namespaces" in json.loads(out_on)["final_answer"]


def test_react_conveyor_equal(monkeypatch, registries):
    """Conveyor on and off, both packages: one transcript and one set of
    flight pairs."""
    got = {}
    for n in PKGS:
        p = package(n)
        for on in (True, False):
            p.obs.flight.get_recorder().reset()
            out, hist = _run_react(p, monkeypatch, registries, _scripted_replies(), on,
                                   lambda s: "namespace-a")
            got[n, on] = (out, hist, flight_events(p))
    assert got["torch", True] == got["jax", True]
    assert got["torch", False] == got["jax", False]
    assert got["jax", True][:2] == got["jax", False][:2]


def test_react_conveyor_chaos_falls_back_to_classic(pkg, monkeypatch, registries):
    calls = []

    def kubectl(s):
        calls.append(s)
        return "namespace-a\nnamespace-b\nnamespace-c"

    base_out, base_hist = _run_react(pkg, monkeypatch, registries, _scripted_replies(), True,
                                     kubectl)
    pkg.obs.flight.get_recorder().reset()
    calls.clear()
    pkg.faults.configure("tool.exec@1")
    try:
        out, hist = _run_react(pkg, monkeypatch, registries, _scripted_replies(), True, kubectl)
    finally:
        pkg.faults.reset()
    assert calls == ["kubectl get ns"]
    assert out == base_out and hist == base_hist
    evs = tool_events(pkg)
    assert [(e["phase"], e.get("conveyor", False)) for e in evs] == [
        ("enter", True), ("exit", True), ("enter", False), ("exit", False)]
    assert evs[1]["outcome"] == "error" and "injected tool subprocess" in evs[1]["error"]
    assert evs[3]["outcome"] == "ok"
    assert pkg.obs.TOOL_CALLS.value(tool="kubectl", outcome="error") == 1.0


def test_react_conveyor_mismatch_cancels_and_reruns(pkg, monkeypatch, registries):
    ToolPrompt = pkg.tools.ToolPrompt

    class Tampering:
        @staticmethod
        def from_json(text):
            t = ToolPrompt.from_json(text)
            if t.action.name:
                t.action.input = t.action.input + " --tampered"
            return t

    monkeypatch.setattr(pkg.react, "ToolPrompt", Tampering)
    calls = []

    def kubectl(s):
        time.sleep(0.05)
        calls.append(s)
        return "namespace-a"

    out, hist = _run_react(pkg, monkeypatch, registries, _scripted_replies(), True, kubectl)
    assert sorted(calls) == ["kubectl get ns", "kubectl get ns --tampered"]
    evs = tool_events(pkg)
    assert [(e["phase"], e.get("conveyor", False)) for e in evs] == [
        ("enter", True), ("exit", True), ("enter", False), ("exit", False)]
    assert evs[1]["outcome"] == "cancelled" and evs[3]["outcome"] == "ok"


def test_react_conveyor_aborts_on_final_answer_turn(pkg, monkeypatch, registries):
    replies = [tp_json(name="", tool_input="", observation="seen",
                       final="Nothing to do here, all healthy.")]
    out, _ = _run_react(pkg, monkeypatch, registries, replies, True, lambda s: "never")
    assert json.loads(out)["final_answer"].startswith("Nothing")
    assert pkg.obs.TOOL_EARLY_LAUNCHES.value(tool="kubectl") == 0.0
    assert tool_events(pkg) == []


def test_timeline_overlap_windows_and_gantt(pkg):
    rec = pkg.obs.flight.get_recorder()
    rid = "req-convey-tl"
    base = time.perf_counter()
    for kind, dt, kw in (
        ("admission", 0.0, dict(seq_id=991, prompt_tokens=8)),
        ("ttft", 0.030, dict(seq_id=991, ttft_ms=30.0)),
        ("tool_exec", 0.040, dict(tool="kubectl", phase="enter", conveyor=True,
                                  launch_offset_ms=12.0)),
        ("tool_exec", 0.070, dict(tool="kubectl", phase="exit", outcome="ok",
                                  duration_ms=30.0, conveyor=True)),
        ("finish", 0.100, dict(seq_id=991, tokens=9, finish_reason="stop")),
    ):
        e = rec.record(kind, request_id=rid, **kw)
        e["ts"] = base + dt
    tl = pkg.obs.timeline.assemble(rid)
    assert abs(tl["tool_overlap_ms"] - 30.0) < 1.0
    w = tl["overlap_windows"][0]
    assert w["tool"] == "kubectl" and abs(w["duration_ms"] - 30.0) < 1.0
    g = pkg.obs.timeline.render_gantt(tl)
    assert "tool_overlap" in g and "tool=kubectl" in g


# -- function calling and workflows: tests/test_funcall.py's cases ----------

def echo_function(p, log):
    return p.funcall.AgentFunction(
        name="kubectl", description="run kubectl",
        parameters={"type": "object", "properties": {"command": {"type": "string"}},
                    "required": ["command"]},
        fn=lambda command: (log.append(command), f"ran: {command}")[1],
    )


def tool_call_msg(name, args, call_id="call_1"):
    return {"role": "assistant", "content": None, "tool_calls": [
        {"id": call_id, "type": "function",
         "function": {"name": name, "arguments": json.dumps(args)}}]}


FUNCALL_CASES = ("roundtrip", "unknown_function", "bad_arguments", "analysis_flow",
                 "generator_flow")


def run_funcall_case(p, name):
    log = []
    client = p.client.ChatClient(api_key="k")
    if name == "roundtrip":
        fake = script(p, [tool_call_msg("kubectl", {"command": "get pods"}),
                          {"role": "assistant", "content": "2 pods are running."}])
        out, hist = p.funcall.run_function_agent(client, "fake://m", "instructions",
                                                 "how many pods?", [echo_function(p, log)])
    elif name == "unknown_function":
        fake = script(p, [tool_call_msg("helm", {}), {"role": "assistant", "content": "ok"}])
        out, hist = p.funcall.run_function_agent(client, "fake://m", "i", "u", [])
    elif name == "bad_arguments":
        fake = script(p, [{"role": "assistant", "content": None, "tool_calls": [
            {"id": "c", "type": "function",
             "function": {"name": "kubectl", "arguments": "{broken"}}]},
            {"role": "assistant", "content": "done"}])
        out, hist = p.funcall.run_function_agent(client, "fake://m", "i", "u",
                                                 [echo_function(p, log)])
    elif name == "analysis_flow":
        fake = script(p, [{"role": "assistant", "content": "Looks fine."}])
        out = p.workflows.analysis_flow("fake://m", "kind: Pod\nmetadata:\n  name: x",
                                        client=client)
        hist = None
    else:
        fake = script(p, [{"role": "assistant", "content": "```yaml\nkind: Deployment\n```"}])
        out = p.workflows.generator_flow("fake://m", "an nginx deployment", client=client)
        hist = None
    return out, hist, fake.requests, log


@pytest.mark.parametrize("name", FUNCALL_CASES)
def test_funcall_case(pkg, name, registries):
    out, hist, requests, log = run_funcall_case(pkg, name)
    last = requests[-1]["messages"][-1]
    if name == "roundtrip":
        assert out == "2 pods are running." and log == ["get pods"]
        assert last == {"role": "tool", "tool_call_id": "call_1", "content": "ran: get pods"}
        assert requests[0]["tools"][0]["function"]["name"] == "kubectl"
    elif name == "unknown_function":
        assert out == "ok" and "not available" in last["content"]
    elif name == "bad_arguments":
        assert out == "done" and log == []
        assert "invalid function arguments" in last["content"]
    elif name == "analysis_flow":
        assert out == "Looks fine." and "kind: Pod" in requests[0]["messages"][1]["content"]
    else:
        assert "Deployment" in out and "tools" not in requests[0]


@pytest.mark.parametrize("name", FUNCALL_CASES)
def test_funcall_case_equal(name, registries):
    got = {n: run_funcall_case(package(n), name) for n in PKGS}
    assert got["torch"] == got["jax"]


def test_assistant_flow_with_config_equal(registries):
    got = {}
    for n in PKGS:
        p = package(n)
        fake = script(p, [tp(observation="seen", final="All workloads look healthy today.")])
        out, hist = p.workflows.assistant_flow_with_config("fake://m", "check workloads")
        got[n] = (out, hist, fake.requests)
    assert got["torch"] == got["jax"]
    assert got["jax"][2][0]["max_tokens"] == 2048


def test_prompts_are_the_jax_packages():
    from opsagent_tpu.agent import prompts as jp
    from opsagent_tpu_torch.agent import prompts as pp

    names = [k for k in vars(jp) if k.isupper()]
    assert len(names) >= 10
    assert all(getattr(pp, k) == getattr(jp, k) for k in names)


# -- the command line, with a scripted provider --------------------------------

FAKE_PROVIDER = """
import json, sys
sys.path.insert(0, {repo!r})
from {pkg}.llm import client
from {pkg} import tools
REPLIES = [
    json.dumps({{"question": "q", "thought": "t", "action": {{"name": "kubectl", "input": "get ns"}},
                "observation": "", "final_answer": ""}}),
    json.dumps({{"question": "q", "thought": "t", "action": {{"name": "", "input": ""}},
                "observation": "3", "final_answer": "There are 3 namespaces here."}}),
    "## Result\\n- 3 namespaces",
]
def provider(target):
    def answer(body):
        return {{"choices": [{{"index": 0, "message": {{"role": "assistant",
                 "content": REPLIES.pop(0)}}, "finish_reason": "stop"}}]}}
    return answer
client.register_provider("fake", provider)
tools.copilot_tools.update({{"kubectl": lambda c: "default\\nkube-system\\nmonitoring"}})
sys.argv = ["opsagent"] + sys.argv[1:]
from {main} import main
sys.exit(main(sys.argv[1:]))
"""
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("args", (["execute", "count namespaces"],
                                  ["execute", "--no-reformat", "count namespaces"],
                                  ["version"]))
def test_cli_prints_what_the_jax_cli_prints(args, tmp_path):
    out = {}
    for pkg_mod, main in (("opsagent_tpu", "opsagent_tpu.cli.main"),
                          ("opsagent_tpu_torch", "opsagent_tpu_torch.cli.main")):
        if "--no-reformat" in args and pkg_mod == "opsagent_tpu":
            continue
        script_path = tmp_path / f"{pkg_mod}.py"
        script_path.write_text(FAKE_PROVIDER.format(repo=REPO, pkg=pkg_mod, main=main))
        res = subprocess.run([sys.executable, str(script_path), *args, "--model", "fake://m"]
                             if args[0] != "version" else [sys.executable, str(script_path),
                                                           *args],
                             capture_output=True, text=True, timeout=120, cwd=str(tmp_path),
                             env={**os.environ, "JAX_PLATFORMS": "cpu"})
        assert res.returncode == 0, res.stderr[-2000:]
        out[pkg_mod] = res.stdout
    if "--no-reformat" in args:
        assert out["opsagent_tpu_torch"].strip() == "There are 3 namespaces here."
    else:
        assert out["opsagent_tpu_torch"] == out["opsagent_tpu"]
        assert out["opsagent_tpu"].strip()
