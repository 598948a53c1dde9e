"""Layered configuration: a YAML file over defaults (the port's copy of
``opsagent_tpu/utils/config.py``).

``load_config`` reads the given file, else ``configs/config.yaml``, else
``./config.yaml``, with the port's own YAML reader (``utils/yamlio.py``: the
machine beside the card has no PyYAML), and merges it over ``DEFAULTS``
(jwt, server, log, perf, serving); a missing file yields the defaults.
"""

from __future__ import annotations

import copy
import os
import threading
from typing import Any

from . import yamlio

DEFAULTS: dict[str, Any] = {
    "jwt": {"key": "opsagent-default-jwt-key"},
    "server": {"port": 8080, "host": "0.0.0.0"},
    "log": {
        "level": "info",
        "format": "json",
        "output": "stdout",
        "file": "logs/opsagent.log",
        "max_size_mb": 10,
        "max_backups": 10,
        "max_age_days": 7,
        "compress": True,
    },
    "perf": {"enabled": True},
    "serving": {
        "model": "",
        "checkpoint": "",
        "tokenizer": "",
        "port": 8000,
        "page_size": 16,
        "max_pages": 2048,
        "max_batch_size": 32,
        "prefill_buckets": [128, 512, 2048, 8192],
        "decode_buckets": [1, 8, 32],
    },
}

_lock = threading.Lock()
_config: dict[str, Any] | None = None


def _deep_merge(base: dict[str, Any], over: dict[str, Any]) -> dict[str, Any]:
    out = dict(base)
    for k, v in over.items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = _deep_merge(out[k], v)
        else:
            out[k] = v
    return out


def load_config(path: str | None = None) -> dict[str, Any]:
    """Load config from ``path``, or search ``configs/config.yaml`` then
    ``./config.yaml``; missing file yields pure defaults."""
    global _config
    candidates = (
        [path]
        if path
        else [
            os.path.join("configs", "config.yaml"),
            "config.yaml",
        ]
    )
    loaded: dict[str, Any] = {}
    for cand in candidates:
        if cand and os.path.isfile(cand):
            with open(cand, "r", encoding="utf-8") as f:
                data = yamlio.safe_load(f) or {}
            if isinstance(data, dict):
                loaded = data
            break
    cfg = _deep_merge(DEFAULTS, loaded)
    with _lock:
        _config = cfg
    return copy.deepcopy(cfg)


def get_config() -> dict[str, Any]:
    with _lock:
        if _config is None:
            pass
        else:
            return copy.deepcopy(_config)
    return load_config()


def reset_config() -> None:
    """Test helper."""
    global _config
    with _lock:
        _config = None
