"""jq tool: apply a jq expression to JSON data (the port's copy of
``opsagent_tpu/tools/jq.py``).

Input convention: ``"<JSON> | <jq-expr>"`` split on the first top-level
pipe; the JSON is validated first and piped to the ``jq`` binary via stdin.
An expression-complexity metric is recorded. When the jq binary is missing
a small built-in evaluator covers the common path/filter forms the agent
emits.
"""

from __future__ import annotations

import json
import re
import subprocess
from typing import Any

from . import ToolError, proc
from ..utils.perf import get_perf_stats

# Conveyor launch readiness (agent/conveyor.py): jq needs BOTH halves of
# its piped input — the JSON document and the expression — before a
# launch makes sense (the single ReAct ``input`` string carries both).
LAUNCH_FIELDS = ("data", "expr")


def _split_input(s: str) -> tuple[str, str]:
    depth = 0
    in_str = False
    esc = False
    for i, c in enumerate(s):
        if esc:
            esc = False
            continue
        if c == "\\":
            esc = True
            continue
        if c == '"':
            in_str = not in_str
            continue
        if in_str:
            continue
        if c in "[{(":
            depth += 1
        elif c in ")}]":
            depth -= 1
        elif c == "|" and depth == 0:
            return s[:i].strip(), s[i + 1 :].strip()
    raise ToolError(
        'jq input must be "<JSON> | <jq-expression>" (no top-level pipe found)'
    )


def _complexity(expr: str) -> int:
    return len(re.findall(r"[.\[\]|()]|select|map|test", expr))


def _eval_path(obj: Any, expr: str) -> Any:
    """Tiny jq subset: .a.b[0], .[], .items[].metadata.name, length."""
    expr = expr.strip()
    if expr == "length":
        return len(obj)
    if not expr.startswith("."):
        raise ToolError(f"built-in jq fallback cannot evaluate: {expr}")
    results = [obj]
    for part in re.finditer(r"\.([A-Za-z_][\w-]*)?(\[\d*\])?", expr):
        key, idx = part.group(1), part.group(2)
        nxt: list[Any] = []
        for cur in results:
            if key is not None:
                if not isinstance(cur, dict) or key not in cur:
                    raise ToolError(f"key not found: {key}")
                cur = cur[key]
            if idx is not None:
                if idx == "[]":
                    if not isinstance(cur, list):
                        raise ToolError("cannot iterate non-array")
                    nxt.extend(cur)
                    continue
                i = int(idx[1:-1])
                if not isinstance(cur, list) or i >= len(cur):
                    raise ToolError(f"index out of range: {i}")
                cur = cur[i]
            nxt.append(cur)
        results = nxt
    if len(results) == 1:
        return results[0]
    return results


def jq(input_str: str, timeout: float = 30.0) -> str:
    data, expr = _split_input(input_str)
    try:
        parsed = json.loads(data)
    except json.JSONDecodeError as e:
        raise ToolError(f"invalid JSON passed to jq: {e}") from e
    ps = get_perf_stats()
    ps.record_metric("tool.jq.complexity", _complexity(expr), "ops")
    with ps.timer("tool.jq"):
        try:
            res = proc.run(
                ["jq", expr], input_text=json.dumps(parsed), timeout=timeout
            )
            if res.returncode != 0:
                raise ToolError(res.stderr.strip() or "jq failed")
            return res.stdout.strip()
        except FileNotFoundError:
            result = _eval_path(parsed, expr)
            if isinstance(result, list):
                return "\n".join(json.dumps(r, ensure_ascii=False) for r in result)
            return json.dumps(result, ensure_ascii=False)
        except subprocess.TimeoutExpired as e:
            raise ToolError(f"jq timed out after {timeout}s") from e
