"""OpenAI-compatible chat client with provider routing (the port's copy of
``opsagent_tpu/llm/client.py``).

A pluggable base URL, Azure detection when the base URL contains "azure"
(the model name, stripped of ``[.:]``, names the deployment), near-greedy
temperature, and up to 5 tries with doubling backoff on HTTP 429/5xx and
connection errors, failing at once on 401 and other 4xx.

A model or base URL of the form ``scheme://target`` (other than http and
https) goes to the provider registered for the scheme: ``cuda://<name>``
reaches the port's serving engine in-process
(``opsagent_tpu_torch.serving.api``, imported on first use), so an agent
loop runs with no HTTP at all.
"""

from __future__ import annotations

import json
import os
import re
import time
import urllib.error
import urllib.request
from typing import Any, Callable

from ..utils.logger import get_logger
from ..utils.perf import get_perf_stats

log = get_logger("llm")


class LLMError(Exception):
    def __init__(self, message: str, status: int = 0):
        super().__init__(message)
        self.status = status


# A provider takes a fully-formed chat.completions request dict and returns a
# chat.completions response dict. Schemes (e.g. "cuda") register factories here.
Provider = Callable[[dict[str, Any]], dict[str, Any]]
_provider_factories: dict[str, Callable[[str], Provider]] = {}

# Schemes whose registration lives in a module imported on first use: a
# client that never names the scheme never loads the serving stack.
_LAZY_SCHEME_MODULES = {"cuda": "opsagent_tpu_torch.serving.api"}


def register_provider(scheme: str, factory: Callable[[str], Provider]) -> None:
    """Register a provider factory for a model/baseURL scheme (e.g. "cuda").
    The factory receives the target (the part after ``scheme://``)."""
    _provider_factories[scheme] = factory


def _resolve_scheme(model: str, base_url: str) -> tuple[str, str] | None:
    for candidate in (model, base_url):
        m = re.match(r"^([a-z][a-z0-9+-]*)://(.*)$", candidate or "")
        if m and m.group(1) not in ("http", "https"):
            return m.group(1), m.group(2)
    return None


class ChatClient:
    """Minimal chat.completions client over urllib (no extra dependencies),
    with the retry ladder and the Azure naming."""

    MAX_RETRIES = 5

    def __init__(self, api_key: str = "", base_url: str = ""):
        self.api_key = api_key or os.environ.get("OPENAI_API_KEY", "")
        self.base_url = (base_url or os.environ.get("OPENAI_API_BASE", "") or
                         "https://api.openai.com/v1").rstrip("/")
        self.is_azure = "azure" in self.base_url.lower()
        self.azure_api_version = "2024-06-01"

    # -- low level ---------------------------------------------------------
    def _endpoint(self, model: str) -> str:
        if self.is_azure:
            deployment = re.sub(r"[.:]", "", model)
            return (
                f"{self.base_url}/openai/deployments/{deployment}"
                f"/chat/completions?api-version={self.azure_api_version}"
            )
        return f"{self.base_url}/chat/completions"

    def _post(self, url: str, body: dict[str, Any], timeout: float) -> dict[str, Any]:
        data = json.dumps(body).encode("utf-8")
        headers = {"Content-Type": "application/json"}
        if self.is_azure:
            headers["api-key"] = self.api_key
        else:
            headers["Authorization"] = f"Bearer {self.api_key}"
        req = urllib.request.Request(url, data=data, headers=headers, method="POST")
        try:
            with urllib.request.urlopen(req, timeout=timeout) as resp:
                return json.loads(resp.read().decode("utf-8"))
        except urllib.error.HTTPError as e:
            detail = ""
            try:
                detail = e.read().decode("utf-8", "replace")[:500]
            except Exception:  # noqa: BLE001
                pass
            raise LLMError(f"HTTP {e.code}: {detail}", status=e.code) from e
        except urllib.error.URLError as e:
            raise LLMError(f"connection error: {e.reason}", status=0) from e

    # -- public ------------------------------------------------------------
    def chat_completion(
        self,
        model: str,
        messages: list[dict[str, Any]],
        max_tokens: int = 2048,
        temperature: float = 1e-45,
        tools: list[dict[str, Any]] | None = None,
        tool_choice: Any = None,
        response_format: dict[str, Any] | None = None,
        timeout: float = 300.0,
    ) -> dict[str, Any]:
        """Full chat.completions round trip returning the raw response dict.

        Retries up to 5 times with doubling backoff on 429/5xx and transient
        connection errors; 401 and other 4xx fail immediately.
        """
        body: dict[str, Any] = {
            "model": model,
            "messages": messages,
            "max_tokens": max_tokens,
            "temperature": temperature,
        }
        if tools:
            body["tools"] = tools
            if tool_choice is not None:
                body["tool_choice"] = tool_choice
        if response_format:
            body["response_format"] = response_format

        scheme = _resolve_scheme(model, self.base_url)
        if scheme is not None:
            name, target = scheme
            factory = _provider_factories.get(name)
            if factory is None and name in _LAZY_SCHEME_MODULES:
                import importlib

                importlib.import_module(_LAZY_SCHEME_MODULES[name])
                factory = _provider_factories.get(name)
            if factory is None:
                raise LLMError(f"no provider registered for scheme {name}://")
            body["model"] = target or model
            provider = factory(target)
            with get_perf_stats().timer(f"llm.chat.{name}"):
                return provider(body)

        url = self._endpoint(model)
        backoff = 1.0
        last: LLMError | None = None
        for attempt in range(self.MAX_RETRIES):
            try:
                with get_perf_stats().timer("llm.chat"):
                    return self._post(url, body, timeout)
            except LLMError as e:
                if e.status == 401:
                    raise
                if e.status == 429 or e.status >= 500 or e.status == 0:
                    last = e
                    log.warning(
                        "chat attempt %d/%d failed (%s); retrying in %.0fs",
                        attempt + 1,
                        self.MAX_RETRIES,
                        e,
                        backoff,
                    )
                    time.sleep(backoff)
                    backoff *= 2
                    continue
                raise
        raise last if last else LLMError("chat failed")

    def chat(
        self,
        model: str,
        max_tokens: int,
        messages: list[dict[str, Any]],
        **kw: Any,
    ) -> str:
        """Convenience wrapper returning the assistant message content."""
        resp = self.chat_completion(model, messages, max_tokens=max_tokens, **kw)
        choices = resp.get("choices") or []
        if not choices:
            raise LLMError("empty choices in chat response")
        return choices[0].get("message", {}).get("content") or ""


def new_client_from_env() -> ChatClient:
    """A client from the environment: OPENAI_API_KEY / OPENAI_API_BASE, or
    AZURE_OPENAI_API_KEY / AZURE_OPENAI_API_BASE."""
    if os.environ.get("AZURE_OPENAI_API_KEY"):
        return ChatClient(
            api_key=os.environ["AZURE_OPENAI_API_KEY"],
            base_url=os.environ.get("AZURE_OPENAI_API_BASE", ""),
        )
    return ChatClient()
