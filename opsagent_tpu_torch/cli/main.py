"""The agent's command line (the port's counterpart of the agent commands of
``opsagent_tpu/cli/main.py``): ``server``, ``execute``, ``analyze``,
``audit``, ``diagnose``, ``generate`` and ``version``, reached as ``python -m
opsagent_tpu_torch <command>``, with ``--config`` (a ``config.yaml``: jwt,
server, log) and the common flags ``--model``, ``--max-tokens``,
``--count-tokens``, ``--verbose``, ``--max-iterations``, ``--api-key``,
``--base-url`` and ``--metrics``.

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

COMMANDS = ("server", "execute", "analyze", "audit", "diagnose", "generate", "version")


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
    return p


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
