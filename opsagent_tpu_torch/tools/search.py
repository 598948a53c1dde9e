"""search tool: Google Custom Search (the port's copy of
``opsagent_tpu/tools/search.py``; GOOGLE_API_KEY / GOOGLE_CSE_ID
credentials from the environment; registered as "search").
"""

from __future__ import annotations

import json
import os
import urllib.parse
import urllib.request

from . import ToolError


def google_search(query: str, timeout: float = 15.0) -> str:
    api_key = os.environ.get("GOOGLE_API_KEY")
    cse_id = os.environ.get("GOOGLE_CSE_ID")
    if not api_key or not cse_id:
        raise ToolError(
            "search tool requires GOOGLE_API_KEY and GOOGLE_CSE_ID environment variables"
        )
    url = "https://customsearch.googleapis.com/customsearch/v1?" + urllib.parse.urlencode(
        {"key": api_key, "cx": cse_id, "q": query, "num": 5}
    )
    try:
        with urllib.request.urlopen(url, timeout=timeout) as resp:
            payload = json.loads(resp.read().decode("utf-8"))
    except Exception as e:  # noqa: BLE001 - network errors become observations
        raise ToolError(f"search failed: {e}") from e
    items = payload.get("items") or []
    if not items:
        return "(no results)"
    lines = []
    for it in items:
        lines.append(f"{it.get('title', '')}\n{it.get('link', '')}\n{it.get('snippet', '')}")
    return "\n\n".join(lines)
