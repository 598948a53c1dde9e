"""YAML extraction from model output (the port's copy of
``opsagent_tpu/utils/yamlutil.py``): the fenced ```yaml``` block the
generate workflow asks for."""

from __future__ import annotations

import re

_FENCE = re.compile(r"```(?:yaml|yml)?\s*\n(.*?)```", re.DOTALL)


def extract_yaml(s: str) -> str:
    """Return the contents of the first fenced YAML block, or the input
    unchanged when no fence is present."""
    m = _FENCE.search(s)
    if m:
        return m.group(1).strip() + "\n"
    return s
