"""OpenAI-compatible HTTP front end for the port's serving engine (the
counterpart of ``opsagent_tpu/serving/api.py``, non-streaming).

``ServingStack`` glues the engine, the scheduler and the chat template;
``make_server`` serves it with the standard library's threading HTTP
server:

- ``POST /v1/chat/completions``: OpenAI chat completion, non-streaming;
- ``GET /healthz``: liveness plus the engine's resolved execution modes.
"""

from __future__ import annotations

import json
import logging
import time
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any

from .chat_template import apply_chat_template
from .engine import Engine
from .sampler import SamplingParams
from .scheduler import Request, RequestError, Scheduler

log = logging.getLogger("opsagent_tpu_torch.api")

# Completion tokens when the request gives no max_tokens.
MAX_NEW_TOKENS_DEFAULT = 1024


class ServingStack:
    """Engine + scheduler + chat glue for one hosted model."""

    def __init__(self, engine: Engine):
        self.engine = engine
        self.model_name = engine.model_cfg.name
        self.scheduler = Scheduler(engine)
        self.scheduler.start()

    def close(self) -> None:
        self.scheduler.stop()

    def _sampling_from(self, body: dict[str, Any]) -> SamplingParams:
        stop = body.get("stop") or []
        return SamplingParams(
            temperature=float(body.get("temperature", 0.0) or 0.0),
            top_k=int(body.get("top_k", 0) or 0),
            top_p=float(body.get("top_p", 1.0) or 1.0),
            max_tokens=int(body.get("max_tokens") or MAX_NEW_TOKENS_DEFAULT),
            stop=(stop,) if isinstance(stop, str) else tuple(stop),
        )

    def _finalize_text(
        self, tokens: list[int], stop: tuple[str, ...], finish_reason: str
    ) -> tuple[str, str]:
        """(text, finish_reason) with EOS and stop-string trimming."""
        finish = finish_reason or "length"
        if tokens and tokens[-1] == self.engine.tokenizer.eos_id:
            tokens, finish = tokens[:-1], "stop"
        text = self.engine.tokenizer.decode(tokens)
        for s in stop:
            idx = text.find(s)
            if idx >= 0:
                text, finish = text[:idx], "stop"
        return text, finish

    def chat_completion(self, body: dict[str, Any]) -> dict[str, Any]:
        """One OpenAI chat completion (``n`` = 1, no streaming)."""
        try:
            sampling = self._sampling_from(body)
            prompt_ids = apply_chat_template(
                self.engine.tokenizer, body.get("messages", []),
                model_family=self.model_name,
            )
        except (ValueError, TypeError, KeyError) as e:
            raise RequestError(f"invalid request: {e}", 400) from e
        if int(body.get("n", 1) or 1) != 1:
            raise RequestError("n must be 1", 400)
        created = int(time.time())
        req = self.scheduler.submit(Request(prompt_ids, sampling))
        if not req.done.wait(600):
            raise RequestError("generation timed out", 504)
        if req.error:
            raise RequestError(req.error, req.error_status)
        text, finish = self._finalize_text(
            req.tokens, sampling.stop, req.finish_reason
        )
        return {
            "id": f"chatcmpl-{uuid.uuid4().hex[:24]}",
            "object": "chat.completion",
            "created": created,
            "model": body.get("model") or self.model_name,
            "choices": [{
                "index": 0,
                "message": {"role": "assistant", "content": text},
                "finish_reason": finish,
            }],
            "usage": {
                "prompt_tokens": len(prompt_ids),
                "completion_tokens": len(req.tokens),
                "total_tokens": len(prompt_ids) + len(req.tokens),
            },
            "ttft_s": req.ttft_s,
        }

    def health(self) -> dict[str, Any]:
        return {
            "status": "ok",
            "model": self.model_name,
            **self.engine.impl_info(),
        }


def make_server(stack: ServingStack, host: str, port: int) -> ThreadingHTTPServer:
    """A threading HTTP server for ``stack`` bound to (host, port); port 0
    picks a free one (read it from ``server.server_address``)."""

    class Handler(BaseHTTPRequestHandler):
        def _reply(self, status: int, payload: dict[str, Any]) -> None:
            data = json.dumps(payload).encode()
            self.send_response(status)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def do_GET(self) -> None:  # noqa: N802 - http.server's name
            if self.path == "/healthz":
                self._reply(200, stack.health())
            else:
                self._reply(404, {"error": {"message": "not found"}})

        def do_POST(self) -> None:  # noqa: N802 - http.server's name
            if self.path != "/v1/chat/completions":
                self._reply(404, {"error": {"message": "not found"}})
                return
            try:
                length = int(self.headers.get("Content-Length", 0))
                body = json.loads(self.rfile.read(length) or b"{}")
                if not isinstance(body, dict):
                    raise ValueError("body must be a JSON object")
            except ValueError as e:
                self._reply(400, {"error": {"message": f"invalid JSON: {e}"}})
                return
            try:
                self._reply(200, stack.chat_completion(body))
            except RequestError as e:
                self._reply(e.status, {"error": {"message": str(e)}})

        def log_message(self, fmt: str, *args: Any) -> None:
            log.debug("%s " + fmt, self.address_string(), *args)

    return ThreadingHTTPServer((host, port), Handler)
