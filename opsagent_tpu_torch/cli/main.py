"""The agent's command line (the port's counterpart of the agent commands of
``opsagent_tpu/cli/main.py``): ``server``, ``execute``, ``analyze``,
``audit``, ``diagnose``, ``generate`` and ``version``, reached as ``python -m
opsagent_tpu_torch <command>``, with ``--config`` (a ``config.yaml``: jwt,
server, log) and the common flags ``--model``, ``--max-tokens``,
``--count-tokens``, ``--verbose``, ``--max-iterations``, ``--api-key``,
``--base-url`` and ``--metrics``; and the operator commands, with the JAX
package's flags, output and exit codes: ``slo-check`` (``cli/slocheck.py``),
``top`` (``cli/top.py``), ``perf-check`` (``cli/perfcheck.py``),
``timeline`` (a request's lifecycle as an ASCII Gantt, a fleet router's
stitched timeline as a multi-lane one), ``fleet-kv`` (a router's page
directory), ``fleet-flight`` (a router's merged flight ledger) and
``audit-fanout`` (``cli/fanout.py``: one audit fanned out over a synthetic
cluster through an in-process fleet, the canonical report on stdout).

``--model cuda://<name>`` runs the model on the port's engine in this
process: a preset's engine is built on the card (``serving.api.get_stack``),
random weights; with ``--checkpoint DIR`` the engine serves that HF
checkpoint (its ``config.json``, its ``tokenizer.json``, f32 where the
config says so, else bf16) under ``<name>``, on ``--device`` (``cuda``
unless ``cpu`` is asked for). The ReAct loop then decodes under the
ToolPrompt schema and streams each turn through the conveyor.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Any

from .. import VERSION
from ..utils.config import load_config
from ..utils.globalstore import set_global
from ..utils.logger import get_logger, init_logger
from ..utils.perf import get_perf_stats

COMMANDS = ("server", "execute", "analyze", "audit", "diagnose", "generate", "version",
            "slo-check", "top", "perf-check", "timeline", "fleet-kv", "fleet-flight",
            "audit-fanout")


def _add_common(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("--model", default="gpt-4", help="model name or cuda://<model>")
    parser.add_argument("--max-tokens", type=int, default=2048)
    parser.add_argument("--count-tokens", action="store_true", default=False)
    parser.add_argument("--verbose", action="store_true", default=False)
    parser.add_argument("--max-iterations", type=int, default=10)
    parser.add_argument("--api-key", default="", help="LLM API key (else env)")
    parser.add_argument("--base-url", default="", help="LLM base URL (else env)")
    parser.add_argument(
        "--metrics", action="store_true", default=False,
        help="print the Prometheus /metrics exposition to stderr after "
             "the run (same text a scrape of a server would return)",
    )
    eng = parser.add_argument_group("cuda:// engine")
    eng.add_argument("--checkpoint", default="",
                     help="HF checkpoint directory the cuda://<name> engine serves, "
                          "with its tokenizer.json and in its config.json's dtype "
                          "(default: the preset <name> with random weights)")
    eng.add_argument("--device", default=None, help="cuda (default) or cpu")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m opsagent_tpu_torch",
        description="Kubernetes AI agent on the port's serving engine",
    )
    p.add_argument("--config", default="", help="path to config.yaml")
    sub = p.add_subparsers(dest="command")

    sp = sub.add_parser("server", help="run the REST API server")
    sp.add_argument("--port", type=int, default=None, help="default: config server.port")
    sp.add_argument("--host", default=None, help="default: config server.host")
    sp.add_argument("--jwt-key", default="")
    sp.add_argument("--show-thought", action="store_true", default=False)
    _add_common(sp)

    ex = sub.add_parser("execute", help="execute operations based on prompt instructions")
    ex.add_argument("instructions", nargs="+")
    ex.add_argument(
        "--no-reformat", action="store_true", default=False,
        help="print the loop's final answer as it is, without the second "
             "model pass that reformats the transcript",
    )
    _add_common(ex)

    an = sub.add_parser("analyze", help="analyze issues for a given resource")
    an.add_argument("--resource", default="pod")
    an.add_argument("--name", required=True)
    an.add_argument("--namespace", default="default")
    _add_common(an)

    au = sub.add_parser("audit", help="audit security issues for a pod")
    au.add_argument("--name", required=True)
    au.add_argument("--namespace", default="default")
    _add_common(au)

    di = sub.add_parser("diagnose", help="diagnose problems for a pod")
    di.add_argument("--name", required=True)
    di.add_argument("--namespace", default="default")
    _add_common(di)

    ge = sub.add_parser("generate", help="generate manifests and optionally apply")
    ge.add_argument("prompt", nargs="+")
    ge.add_argument("--yes", action="store_true", help="apply without confirmation")
    _add_common(ge)

    sub.add_parser("version", help="print version")

    sc = sub.add_parser(
        "slo-check",
        help="evaluate the declared serving SLOs (bench/CI gate: exit 0 "
             "pass, 1 breach, 2 no data)",
    )
    sc.add_argument("--url", default="",
                    help="base URL of a running server; fetches GET /api/slo")
    sc.add_argument("--bench", default="",
                    help="BENCH json/jsonl file; reads the extra.slo verdicts")
    sc.add_argument(
        "--class", dest="slo_class", default="",
        choices=["", "interactive", "batch", "background"],
        help="gate one SLO class's attainment/burn (from the per-class "
             "report) instead of the global verdicts",
    )

    tp = sub.add_parser(
        "top",
        help="live fleet cockpit: replica table, per-class SLO rows "
             "with history sparklines, anomaly tail (ANSI, no curses)",
    )
    tp.add_argument("--url", default="http://127.0.0.1:8090",
                    help="base URL of a fleet router (or a single engine/agent "
                         "server — the replica table degrades gracefully)")
    tp.add_argument("--interval", type=float, default=2.0, help="seconds between frames")
    tp.add_argument("--frames", type=int, default=0,
                    help="render N frames then exit (0 = until interrupted)")
    tp.add_argument("--no-color", action="store_true", default=False,
                    help="disable ANSI colors even on a TTY")

    pc = sub.add_parser(
        "perf-check",
        help="compare a fresh bench jsonl against the committed "
             "BENCH_r*_local.jsonl baseline with noise tolerances "
             "(CI gate: exit 0 pass, 1 regression, 2 nothing comparable)",
    )
    pc.add_argument("current",
                    help="fresh bench jsonl (result lines), or a fleet router URL "
                         "(http://...: live rows from GET /api/fleet/bench)")
    pc.add_argument("--baseline", default="",
                    help="baseline jsonl (default: newest committed BENCH_r*_local.jsonl)")
    pc.add_argument("--tolerance", type=float, default=None,
                    help="global relative tolerance (default 10%%, TTFT series 25%%)")
    pc.add_argument("--tolerances", default="",
                    help="JSON file of {metric substring: tolerance} overrides")

    tl = sub.add_parser(
        "timeline",
        help="render a request's lifecycle timeline as an ASCII Gantt "
             "(queue -> prefill -> decode -> tool-blocked, with the "
             "goodput split)",
    )
    tl.add_argument("request_id", help="request id (chatcmpl-... / req-...)")
    tl.add_argument("--url", default="",
                    help="base URL of a running server; fetches "
                         "GET /api/timeline/{request_id}")
    tl.add_argument("--token", default="",
                    help="bearer token for the agent server's JWT-guarded /api/ tree")
    tl.add_argument("--file", default="",
                    help="read the timeline JSON from a file instead (e.g. the "
                         "'timeline' line of a flight anomaly dump)")
    tl.add_argument("--width", type=int, default=64, help="gantt bar width")
    tl.add_argument("--json", action="store_true", default=False,
                    help="print the raw timeline JSON instead of the gantt")

    fkv = sub.add_parser(
        "fleet-kv",
        help="dump the fleet router's global KV page directory (which "
             "replica owns which prefix chains, tier footprints, "
             "advertisement staleness)",
    )
    fkv.add_argument("--url", default="http://127.0.0.1:8090",
                     help="fleet router base URL; fetches GET /api/fleet/directory")
    fkv.add_argument("--limit", type=int, default=256,
                     help="max chain rows to fetch (the directory can hold thousands)")
    fkv.add_argument("--json", action="store_true", default=False,
                     help="print the raw directory JSON instead of the table")

    ffl = sub.add_parser(
        "fleet-flight",
        help="dump the fleet flight ledger: every replica's flight "
             "ring merged into one replica-tagged, skew-corrected, "
             "time-ordered event stream",
    )
    ffl.add_argument("--url", default="http://127.0.0.1:8090",
                     help="fleet router base URL; fetches GET /api/fleet/flight")
    ffl.add_argument("--n", type=int, default=64,
                     help="merged event tail length (0 = everything in the rings)")
    ffl.add_argument("--kind", default="", help="filter by event kind")
    ffl.add_argument("--request-id", default="",
                     help="filter to one journey's events (implies no tail cap)")
    ffl.add_argument("--json", action="store_true", default=False,
                     help="print the raw ledger JSON instead of the table")

    af = sub.add_parser(
        "audit-fanout",
        help="fan one audit out over a synthetic cluster: N batch-class "
             "child sessions sharing one prefix chain through an "
             "in-process fleet, reduced to one deterministic report "
             "(exit 0 all children ok, 1 any finding_unavailable)",
    )
    af.add_argument("--model", default="tiny-test")
    af.add_argument("--resources", type=int, default=64,
                    help="synthetic cluster size (= fan-out children)")
    af.add_argument("--seed", type=int, default=0)
    af.add_argument("--issue-fraction", type=float, default=0.25,
                    help="fraction of resources given an injected issue")
    af.add_argument("--replicas", type=int, default=2,
                    help="in-process decode replicas behind the router")
    af.add_argument("--max-inflight", type=int, default=8,
                    help="bounded scatter concurrency (the fan-out admission gate)")
    af.add_argument("--max-tokens", type=int, default=16)
    af.add_argument("--flight-sample", type=int, default=0,
                    help=">1: sample admission/dispatch flight kinds 1-in-N during "
                         "the wave (flood control)")
    af.add_argument("--json", action="store_true",
                    help="print the canonical byte-stable report form")
    af.add_argument("--out", default="", help="also write the canonical report here")
    af.add_argument("--device", default=None, help="cuda (default) or cpu")
    return p


def _fetch_json(url: str, timeout: float, token: str = "") -> Any:
    import json
    import urllib.request

    req = urllib.request.Request(url)
    if token:
        req.add_header("Authorization", f"Bearer {token}")
    with urllib.request.urlopen(req, timeout=timeout) as resp:  # noqa: S310 - operator URL
        return json.loads(resp.read().decode())


def run_ops_command(args: argparse.Namespace) -> int:
    """The operator commands: ``slo-check``, ``top``, ``perf-check``,
    ``timeline``, ``fleet-kv``, ``fleet-flight`` and ``audit-fanout``, with
    the JAX package's output and exit codes."""
    import json

    if args.command == "audit-fanout":
        from .fanout import run_audit_fanout

        return run_audit_fanout(
            model=args.model, resources=args.resources, seed=args.seed,
            issue_fraction=args.issue_fraction, replicas=args.replicas,
            max_inflight=args.max_inflight, max_tokens=args.max_tokens,
            flight_sample=args.flight_sample, as_json=args.json, out=args.out,
            device=args.device,
        )
    if args.command == "slo-check":
        from .slocheck import run_slo_check

        return run_slo_check(url=args.url, bench=args.bench, slo_class=args.slo_class)
    if args.command == "top":
        from .top import run_top

        return run_top(args.url, interval_s=args.interval, frames=args.frames,
                       color=False if args.no_color else None)
    if args.command == "perf-check":
        from .perfcheck import run_perf_check

        return run_perf_check(args.current, baseline=args.baseline,
                              tolerance=args.tolerance, tolerances_file=args.tolerances)
    if args.command == "timeline":
        from ..obs import timeline as obs_timeline

        if args.file:
            with open(args.file) as f:
                data = json.load(f)
            # A bare timeline, or a flight dump's "timeline" context line.
            tl_data = data.get("timeline", data) if isinstance(data, dict) else data
        elif args.url:
            try:
                tl_data = _fetch_json(
                    args.url.rstrip("/") + f"/api/timeline/{args.request_id}", 10, args.token)
            except Exception as e:  # noqa: BLE001 - CLI surface
                print(f"timeline fetch failed: {e}", file=sys.stderr)
                return 1
        else:
            # Same-process assembly (after an in-process cuda:// run).
            tl_data = obs_timeline.assemble(args.request_id)
            if tl_data is None:
                print(f"unknown request_id {args.request_id!r} in this process; pass "
                      "--url for a running server or --file for a dump", file=sys.stderr)
                return 1
        if args.json:
            print(json.dumps(tl_data, indent=2))
        elif isinstance(tl_data, dict) and tl_data.get("fleet"):
            # A router's stitched timeline: one lane per replica plus the
            # router-side windows.
            print(obs_timeline.render_fleet_gantt(tl_data, width=args.width))
        else:
            print(obs_timeline.render_gantt(tl_data, width=args.width))
        return 0
    if args.command == "fleet-kv":
        try:
            snap = _fetch_json(args.url.rstrip("/") + f"/api/fleet/directory?limit={args.limit}",
                               10)
        except Exception as e:  # noqa: BLE001 - CLI surface
            print(f"directory fetch failed: {e}", file=sys.stderr)
            return 1
        if args.json:
            print(json.dumps(snap, indent=2))
            return 0
        st = snap.get("stats", {})
        print(
            f"directory: {st.get('chains', 0)} chains over "
            f"{st.get('replicas', 0)} replicas | lookups "
            f"{st.get('lookups', 0)} (hits {st.get('hits', 0)}, misses "
            f"{st.get('misses', 0)}), stale evictions "
            f"{st.get('stale_evictions', 0)}"
        )
        replicas = snap.get("replicas", [])
        if replicas:
            print(f"\n{'replica':<16} {'role':<8} {'state':<9} "
                  f"{'digests':>8} {'pool pages':>11} {'hb age':>8}")
            for r in replicas:
                digests = str(r.get("digest_count", 0))
                if r.get("digest_truncated"):
                    digests += "+"
                print(
                    f"{r.get('id', '?'):<16} {r.get('role', '?'):<8} "
                    f"{r.get('state', '?'):<9} {digests:>8} "
                    f"{r.get('host_pool_pages', 0):>11} "
                    f"{r.get('heartbeat_age_s', 0):>7.1f}s"
                )
        rows = snap.get("rows", [])
        if rows:
            print(f"\n{'chain':<14} {'owners (freshest first)'}")
            for row in rows:
                owners = ", ".join(f"{o.get('id', '?')} ({o.get('age_s', 0):.1f}s)"
                                   for o in row.get("owners", []))
                print(f"{row.get('chain', '?')[:12]:<14} {owners}")
            if snap.get("truncated"):
                print(f"... truncated at {len(rows)} rows (raise --limit for more)")
        return 0
    # fleet-flight
    from urllib.parse import quote

    url = (args.url.rstrip("/") + f"/api/fleet/flight?n={args.n}"
           + (f"&kind={quote(args.kind)}" if args.kind else "")
           + (f"&request_id={quote(args.request_id)}" if args.request_id else ""))
    try:
        ledger = _fetch_json(url, 15)
    except Exception as e:  # noqa: BLE001 - CLI surface
        print(f"fleet flight fetch failed: {e}", file=sys.stderr)
        return 1
    if args.json:
        print(json.dumps(ledger, indent=2))
        return 0
    offsets = ledger.get("clock_offset_s", {})
    if offsets:
        print("clock offsets: " + ", ".join(
            f"{r}={o * 1e3:+.1f}ms" for r, o in sorted(offsets.items())))
    events = ledger.get("events", [])
    print(f"{len(events)} events from {len(ledger.get('replicas', []))} replicas\n")
    for e in events:
        wall = e.get("wall_corrected", e.get("wall", 0.0))
        extras = " ".join(f"{k}={v}" for k, v in e.items()
                          if k not in ("kind", "source", "replica", "wall",
                                       "wall_corrected", "ts", "id"))
        print(f"{wall:>17.6f} {e.get('source', '?'):<10} "
              f"{e.get('kind', '?'):<18} {extras}")
    return 0


def _cfg_int(value: Any, default: int) -> int:
    return default if value is None else int(value)


def install_checkpoint_stack(args: argparse.Namespace) -> None:
    """Serve ``--checkpoint`` under the name of ``--model cuda://<name>``
    (warmed up first), in f32 when its ``config.json`` says so, else bf16;
    without a checkpoint, ``get_stack`` builds the preset's engine on first
    use."""
    if not (args.model.startswith("cuda://") and args.checkpoint):
        return
    import json

    import torch

    from ..serving.api import ServingStack, install_stack
    from ..serving.engine import Engine, EngineConfig

    with open(os.path.join(args.checkpoint, "config.json"), encoding="utf-8") as f:
        hf = json.load(f)
    f32 = (hf.get("torch_dtype") or hf.get("dtype")) == "float32"
    tokenizer = args.checkpoint if os.path.exists(
        os.path.join(args.checkpoint, "tokenizer.json")) else ""
    engine = Engine(EngineConfig(
        model="auto", checkpoint=args.checkpoint, tokenizer=tokenizer,
        dtype=torch.float32 if f32 else torch.bfloat16, device=args.device,
    ))
    engine.warmup()
    install_stack(args.model[len("cuda://"):], ServingStack(engine))


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    cfg = load_config(args.config or None)
    log_cfg = cfg.get("log", {})
    init_logger(
        level=log_cfg.get("level", "info"),
        fmt=log_cfg.get("format", "json"),
        output=log_cfg.get("output", "stdout"),
        file_path=log_cfg.get("file", "logs/opsagent.log"),
        # Null-in-YAML (a commented-out value) falls back to the default;
        # an explicit 0 is kept (maxBytes=0 / backupCount=0 disable).
        max_size_mb=_cfg_int(log_cfg.get("max_size_mb"), 10),
        max_backups=_cfg_int(log_cfg.get("max_backups"), 10),
        retention_days=_cfg_int(log_cfg.get("max_age_days"), 7),
        compress=bool(log_cfg.get("compress", True)),
    )
    log = get_logger("cli")

    if args.command is None:
        build_parser().print_help()
        return 1

    if args.command == "version":
        print(f"opsagent {VERSION}")
        return 0

    if args.command in COMMANDS[COMMANDS.index("slo-check"):]:
        return run_ops_command(args)

    install_checkpoint_stack(args)

    if args.command == "server":
        # Precedence: flag > env (how k8s Secrets are injected) > config file.
        jwt_key = (
            args.jwt_key
            or os.environ.get("OPSAGENT_JWT_KEY", "")
            or cfg.get("jwt", {}).get("key", "")
        )
        set_global("jwtKey", jwt_key)
        set_global("showThought", args.show_thought)
        from ..server.app import run_server

        srv_cfg = cfg.get("server", {})
        run_server(
            host=args.host or srv_cfg.get("host", "0.0.0.0"),
            port=args.port or srv_cfg.get("port", 8080),
        )
        return 0

    from .. import obs
    from ..utils.term import render_markdown

    if args.command == "execute":
        from ..agent.prompts import REACT_SYSTEM_PROMPT, REFORMAT_PROMPT
        from ..agent.react import assistant_with_config
        from ..utils.jsonrepair import extract_field
        from ..workflows import assistant_flow

        instructions = " ".join(args.instructions)
        messages = [
            {"role": "system", "content": REACT_SYSTEM_PROMPT},
            {"role": "user", "content": f"Here are the instructions: {instructions}"},
        ]
        # Root the request trace here so verbose runs can print the span
        # summary afterwards.
        with obs.trace_request(obs.new_request_id("cli")) as tr:
            response, _ = assistant_with_config(
                args.model, messages, args.max_tokens, args.count_tokens,
                args.verbose, args.max_iterations, args.api_key, args.base_url,
            )
        if args.no_reformat:
            result = extract_field(response, "final_answer") or response
        else:
            # A second pass purely to reformat the transcript for the reader.
            try:
                from ..llm.client import ChatClient

                client = ChatClient(api_key=args.api_key, base_url=args.base_url)
                result = assistant_flow(args.model, REFORMAT_PROMPT + response, client=client)
            except Exception:  # noqa: BLE001 - reformat is best-effort
                result = response
        print(render_markdown(result))
        if args.verbose:
            print(get_perf_stats().format_table(), file=sys.stderr)
            print(obs.format_tree(tr.to_dict()), file=sys.stderr)
        if args.metrics:
            print(obs.metrics_text(), file=sys.stderr, end="")
        return 0

    if args.command == "analyze":
        from ..k8s import get_yaml
        from ..workflows import analysis_flow

        manifest = get_yaml(args.resource, args.name, args.namespace)
        result = analysis_flow(args.model, manifest)
        print(render_markdown(result))
        return 0

    if args.command == "audit":
        from ..workflows import audit_flow

        result = audit_flow(args.model, args.name, args.namespace)
        print(render_markdown(result))
        return 0

    if args.command == "diagnose":
        from ..agent.prompts import DIAGNOSE_SYSTEM_PROMPT
        from ..agent.react import assistant_with_config
        from ..utils.jsonrepair import extract_field

        messages = [
            {"role": "system", "content": DIAGNOSE_SYSTEM_PROMPT},
            {
                "role": "user",
                "content": (
                    f"Diagnose the Pod '{args.name}' in namespace "
                    f"'{args.namespace}'."
                ),
            },
        ]
        with obs.trace_request(obs.new_request_id("cli")) as tr:
            response, _ = assistant_with_config(
                args.model, messages, args.max_tokens, args.count_tokens,
                args.verbose, args.max_iterations, args.api_key, args.base_url,
            )
        final = extract_field(response, "final_answer") or response
        print(render_markdown(final))
        if args.verbose:
            print(obs.format_tree(tr.to_dict()), file=sys.stderr)
        if args.metrics:
            print(obs.metrics_text(), file=sys.stderr, end="")
        return 0

    if args.command == "generate":
        from ..utils.yamlutil import extract_yaml
        from ..workflows import generator_flow

        prompt = " ".join(args.prompt)
        result = generator_flow(args.model, prompt)
        manifests = extract_yaml(result)
        print(render_markdown(result))
        if not args.yes:
            try:
                answer = input("Apply these manifests to the cluster? (y/N) ")
            except EOFError:
                answer = "n"
            if answer.strip().lower() not in ("y", "yes"):
                log.info("apply skipped")
                return 0
        from ..k8s import apply_yaml

        applied = apply_yaml(manifests)
        for item in applied:
            print(f"applied: {item}")
        return 0

    return 1


if __name__ == "__main__":
    sys.exit(main())
