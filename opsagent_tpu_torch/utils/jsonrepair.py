"""Tolerant JSON parsing for model output (the port's copy of
``opsagent_tpu/utils/jsonrepair.py``'s ``parse_json`` and what it calls).

Models emit JSON wrapped in markdown fences, with unescaped newlines inside
strings, trailing commas, or stray prose around the object. ``parse_json``
recovers a parseable object from such output: the chat API reads a
``tool_calls`` reply with it, the agent loop a ToolPrompt reply.
``extract_field`` pulls one field out of JSON-ish text that even the repair
cannot parse.
"""

from __future__ import annotations

import json
import re
from typing import Any


def _strip_code_fences(s: str) -> str:
    """Remove markdown code fences (```json ... ```)."""
    m = re.search(r"```(?:json)?\s*\n?(.*?)```", s, re.DOTALL)
    if m:
        return m.group(1)
    return s


def _extract_braced(s: str) -> str:
    """Extract the substring from the first '{' to its balanced closing '}'.

    Falls back to first-'{'..last-'}' when braces never balance (e.g. the
    model stopped mid-object).
    """
    start = s.find("{")
    if start < 0:
        return s
    depth = 0
    in_str = False
    esc = False
    for i in range(start, len(s)):
        c = s[i]
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
        if c == "{":
            depth += 1
        elif c == "}":
            depth -= 1
            if depth == 0:
                return s[start : i + 1]
    end = s.rfind("}")
    if end > start:
        return s[start : end + 1]
    return s[start:]


def _escape_newlines_in_strings(s: str) -> str:
    """Escape literal newlines/tabs that appear inside JSON string literals."""
    out: list[str] = []
    in_str = False
    esc = False
    for c in s:
        if esc:
            out.append(c)
            esc = False
            continue
        if c == "\\":
            out.append(c)
            esc = True
            continue
        if c == '"':
            in_str = not in_str
            out.append(c)
            continue
        if in_str and c == "\n":
            out.append("\\n")
        elif in_str and c == "\r":
            out.append("\\r")
        elif in_str and c == "\t":
            out.append("\\t")
        else:
            out.append(c)
    return "".join(out)


_TRAILING_COMMA = re.compile(r",\s*([}\]])")


def _remove_trailing_commas(s: str) -> str:
    return _TRAILING_COMMA.sub(r"\1", s)


def _close_unterminated(s: str) -> str:
    """Best-effort close of an object the model stopped generating mid-way."""
    depth = 0
    in_str = False
    esc = False
    for c in s:
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
        if c == "{" or c == "[":
            depth += 1
        elif c == "}" or c == "]":
            depth -= 1
    if in_str:
        s = s + '"'
    if depth > 0:
        s = s + "}" * depth
    return s


def clean_json(s: str) -> str:
    """Normalize sloppy LLM output into (hopefully) parseable JSON text.

    Steps: strip code fences -> extract the balanced braced region -> escape
    raw newlines inside strings -> drop trailing commas -> close unterminated
    braces/strings.
    """
    s = _strip_code_fences(s)
    s = _extract_braced(s)
    s = _escape_newlines_in_strings(s)
    s = _remove_trailing_commas(s)
    s = _close_unterminated(s)
    return s.strip()


def parse_json(s: str) -> Any:
    """Parse JSON, strictly first, then after ``clean_json`` repair.

    Raises ``ValueError`` when even the repaired text does not parse.
    """
    try:
        return json.loads(s)
    except (json.JSONDecodeError, TypeError):
        pass
    cleaned = clean_json(s)
    try:
        return json.loads(cleaned)
    except json.JSONDecodeError as e:
        raise ValueError(f"unparseable JSON after repair: {e}") from e


def extract_field(s: str, field: str) -> str:
    """Extract a top-level string field from JSON-ish text.

    Tries full parse (strict then repaired) and a dict lookup; falls back to a
    regex over the raw text that tolerates escaped quotes in the value.
    Returns "" when the field cannot be found.
    """
    for attempt in (s, None):
        try:
            obj = json.loads(s) if attempt is not None else json.loads(clean_json(s))
        except (json.JSONDecodeError, TypeError):
            continue
        if isinstance(obj, dict) and field in obj:
            v = obj[field]
            if isinstance(v, str):
                return v
            return json.dumps(v, ensure_ascii=False)
    # Regex fallback: "field" : "value with \" escapes"
    pat = re.compile(
        r'"' + re.escape(field) + r'"\s*:\s*"((?:[^"\\]|\\.)*)"', re.DOTALL
    )
    m = pat.search(s)
    if m:
        raw = m.group(1)
        try:
            return json.loads('"' + raw + '"')
        except json.JSONDecodeError:
            return raw
    # Non-string value fallback: "field": {...} / [...] / number / bool
    pat2 = re.compile(r'"' + re.escape(field) + r'"\s*:\s*([\[{].*?[\]}]|[^,}\]]+)', re.DOTALL)
    m = pat2.search(s)
    if m:
        return m.group(1).strip()
    return ""
