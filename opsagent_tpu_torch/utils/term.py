"""Terminal markdown rendering (the port's copy of
``opsagent_tpu/utils/term.py``): a lightweight ANSI renderer for headers,
bold, inline code, fenced code blocks, bullets and rules, plain text when
the output is not a terminal."""

from __future__ import annotations

import re
import shutil
import sys

_BOLD = "\033[1m"
_DIM = "\033[2m"
_CYAN = "\033[36m"
_YELLOW = "\033[33m"
_RESET = "\033[0m"


def _inline(s: str, color: bool) -> str:
    if not color:
        return s
    s = re.sub(r"\*\*(.+?)\*\*", _BOLD + r"\1" + _RESET, s)
    s = re.sub(r"`([^`]+)`", _CYAN + r"\1" + _RESET, s)
    return s


def render_markdown(text: str, width: int | None = None, color: bool | None = None) -> str:
    if color is None:
        color = sys.stdout.isatty()
    if width is None:
        width = min(shutil.get_terminal_size((100, 24)).columns, 120)
    out: list[str] = []
    in_code = False
    for line in text.splitlines():
        if line.strip().startswith("```"):
            in_code = not in_code
            out.append((_DIM if color else "") + "-" * 4 + (_RESET if color else ""))
            continue
        if in_code:
            out.append(("  " + line) if not color else ("  " + _YELLOW + line + _RESET))
            continue
        m = re.match(r"^(#{1,6})\s+(.*)$", line)
        if m:
            title = m.group(2)
            out.append((_BOLD + title + _RESET) if color else title.upper())
            continue
        if re.match(r"^\s*[-*]\s+", line):
            out.append(re.sub(r"^(\s*)[-*]\s+", r"\1• ", _inline(line, color)))
            continue
        if re.match(r"^\s*(---+|\*\*\*+)\s*$", line):
            out.append("-" * min(width, 40))
            continue
        out.append(_inline(line, color))
    return "\n".join(out)
