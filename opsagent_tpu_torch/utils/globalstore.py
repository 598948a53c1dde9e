"""Process-wide key/value store bridging config, CLI flags and handlers (the
port's copy of ``opsagent_tpu/utils/globalstore.py``): the JWT key, the
login credentials, ``showThought`` and ``allowAnonymousLLM``."""

from __future__ import annotations

import threading
from typing import Any

_lock = threading.RLock()
_store: dict[str, Any] = {}


def set_global(key: str, value: Any) -> None:
    with _lock:
        _store[key] = value


def get_global(key: str, default: Any = None) -> Any:
    with _lock:
        return _store.get(key, default)


def delete_global(key: str) -> None:
    with _lock:
        _store.pop(key, None)


def clear_globals() -> None:
    """Test helper: reset the store."""
    with _lock:
        _store.clear()
