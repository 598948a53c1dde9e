"""OpenAI-compatible HTTP front end for the port's serving engine (the
counterpart of ``opsagent_tpu/serving/api.py``).

``ServingStack`` glues the engine, the scheduler and the chat template;
``make_server`` serves it with the standard library's threading HTTP
server:

- ``POST /v1/chat/completions``: OpenAI chat completion, ``n`` = 1, with
  ``response_format`` (``json_object``, ``json_schema``: constrained
  decoding) and ``stream: true`` (server-sent events, ``data: [DONE]``
  last). ``tool_choice`` that forces a call, ``logprobs``,
  ``logit_bias``, presence and frequency penalties and ``n`` > 1 are
  refused with 400, never ignored;
- ``GET /healthz``: liveness plus the engine's resolved execution modes.

HTTP handler threads never touch CUDA: a stream reads the tokens that the
scheduler thread puts on a queue.
"""

from __future__ import annotations

import json
import logging
import queue
import threading
import time
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Iterator

from .chat_template import apply_chat_template
from .constrained import JsonConstraint, device_table_fsm, json_constraint
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

    @staticmethod
    def _refuse_unsupported(body: dict[str, Any]) -> None:
        """Fields of the OpenAI API that this engine does not implement
        raise ValueError naming the field, so a client never gets an answer
        that silently ignored them."""
        if body.get("tool_choice") not in (None, "auto", "none"):
            raise ValueError("tool_choice that forces a call is not supported")
        for name in ("logprobs", "top_logprobs", "logit_bias",
                     "presence_penalty", "frequency_penalty"):
            if body.get(name):
                raise ValueError(f"{name} is not supported")
        if int(body.get("n", 1) or 1) != 1:
            raise ValueError("n must be 1")

    def _constraint_from(self, body: dict[str, Any]) -> JsonConstraint | None:
        """OpenAI ``response_format`` -> constrained-decoding mask_fn:
        ``json_object`` constrains to any JSON value, ``json_schema`` to the
        given schema. An unknown type, a malformed schema or one whose DFA
        is over the limit raises ValueError."""
        rf = body.get("response_format")
        if not rf:
            return None
        if not isinstance(rf, dict):
            raise ValueError(f"response_format must be an object, got {rf!r}")
        kind = rf.get("type")
        if kind == "json_object":
            schema = None
        elif kind == "json_schema":
            spec = rf.get("json_schema") or {}
            if not isinstance(spec, dict):
                raise ValueError("response_format.json_schema must be an object")
            if "schema" in spec:
                schema = spec["schema"]
            elif any(k in spec for k in ("type", "properties", "enum", "items")):
                schema = spec  # schema passed bare, not nested under "schema"
            else:
                raise ValueError(
                    "response_format.json_schema carries no schema "
                    '(expected a "schema" member or an inline JSON schema)'
                )
            if not isinstance(schema, dict):
                raise ValueError("json_schema.schema must be an object")
        else:
            raise ValueError(f"unsupported response_format type {kind!r}")
        mask_fn = json_constraint(self.engine.tokenizer, schema or None)
        # The dense device tables, where they fit, are built here on the
        # handler's thread rather than on the scheduler's.
        device_table_fsm(mask_fn)
        return mask_fn

    def _translate(
        self, body: dict[str, Any]
    ) -> tuple[SamplingParams, list[int], JsonConstraint | None]:
        """(sampling, prompt ids, mask_fn) of a request; a malformed or
        unsupported one raises RequestError 400."""
        try:
            self._refuse_unsupported(body)
            sampling = self._sampling_from(body)
            prompt_ids = apply_chat_template(
                self.engine.tokenizer, body.get("messages", []),
                model_family=self.model_name,
            )
            return sampling, prompt_ids, self._constraint_from(body)
        except (ValueError, TypeError, KeyError) as e:
            raise RequestError(f"invalid request: {e}", 400) from e

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
        sampling, prompt_ids, mask_fn = self._translate(body)
        created = int(time.time())
        req = self.scheduler.submit(Request(prompt_ids, sampling, mask_fn=mask_fn))
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

    def chat_completion_stream(self, body: dict[str, Any]) -> Iterator[dict[str, Any]]:
        """One chat completion as a generator of SSE chunk dicts. Nothing
        is yielded until the admission's outcome is known: a request that
        fails admission raises RequestError from the first ``next``, so the
        server answers it with an HTTP status, not a 200 stream."""
        sampling, prompt_ids, mask_fn = self._translate(body)
        token_q: "queue.Queue[int | None]" = queue.Queue()
        req = self.scheduler.submit(
            Request(prompt_ids, sampling, mask_fn=mask_fn, on_token=token_q.put)
        )
        cid = f"chatcmpl-{uuid.uuid4().hex[:24]}"
        created = int(time.time())
        model = body.get("model") or self.model_name

        def chunk(delta: dict[str, Any], finish: str | None = None) -> dict[str, Any]:
            return {
                "id": cid,
                "object": "chat.completion.chunk",
                "created": created,
                "model": model,
                "choices": [{"index": 0, "delta": delta, "finish_reason": finish}],
            }

        yield from self._stream_events(req, token_q, chunk, sampling)

    def _stream_events(self, req, token_q, chunk, sampling):
        # The scheduler sets done after the request's last token: a None
        # behind it ends the token stream.
        threading.Thread(
            target=lambda: (req.done.wait(600), token_q.put(None)), daemon=True
        ).start()
        first_tok = token_q.get()
        if first_tok is None and req.error:
            raise RequestError(req.error, req.error_status)
        yield chunk({"role": "assistant", "content": ""})

        def tokens():
            t = first_tok
            while t is not None:
                yield t
                t = token_q.get()

        # Incremental detokenization over a sliding window: decode only
        # sent[prefix_off:] and diff it against the same window's previous
        # decode. A trailing "\ufffd" (a multi-byte character not yet
        # complete) waits for more tokens until the last one, and
        # max_stop - 1 characters are held back so that a stop string
        # across two chunks is still cut.
        decode = self.engine.tokenizer.decode
        eos = self.engine.tokenizer.eos_id
        max_stop = max((len(s) for s in sampling.stop), default=0)
        sent: list[int] = []
        prefix_off = read_off = 0
        pending = ""     # decoded, not yet emitted (stop-string holdback)
        stopped = False

        def delta(final: bool) -> str:
            nonlocal prefix_off, read_off
            prefix_text = decode(sent[prefix_off:read_off])
            window_text = decode(sent[prefix_off:])
            if window_text.endswith("\ufffd") and not final:
                return ""
            cut = len(prefix_text)
            if window_text[:cut] != prefix_text:
                cut = 0
                for x, y in zip(prefix_text, window_text):
                    if x != y:
                        break
                    cut += 1
            prefix_off, read_off = read_off, len(sent)
            return window_text[cut:]

        def take(text: str) -> str:
            """Adds ``text`` to the holdback; returns what may go out."""
            nonlocal pending, stopped
            pending += text
            for s in sampling.stop:
                idx = pending.find(s)
                if idx >= 0:
                    pending, stopped = pending[:idx], True
                    break
            if stopped or max_stop <= 1:
                emit, pending = pending, ""
            else:
                emit, pending = pending[: -(max_stop - 1)], pending[-(max_stop - 1):]
            return emit

        for tok in tokens():
            if tok == eos or stopped:
                continue
            sent.append(tok)
            if emit := take(delta(final=False)):
                yield chunk({"content": emit})
        if not stopped and read_off < len(sent) and (emit := take(delta(final=True))):
            yield chunk({"content": emit})
        if req.error:
            yield {"error": {"message": req.error}}
            return
        if pending:
            yield chunk({"content": pending})
        yield chunk({}, finish="stop" if stopped else (req.finish_reason or "length"))

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

        def _stream(self, body: dict[str, Any]) -> None:
            """Server-sent events: one ``data:`` line per chunk, then
            ``data: [DONE]``. The first chunk is pulled before the status
            is sent, so a request that fails admission gets its status."""
            events = stack.chat_completion_stream(body)
            try:
                first = next(events, None)
            except RequestError as e:
                self._reply(e.status, {"error": {"message": str(e)}})
                return
            self.send_response(200)
            self.send_header("Content-Type", "text/event-stream")
            self.send_header("Cache-Control", "no-cache")
            self.end_headers()
            self.close_connection = True
            try:
                event = first
                while event is not None:
                    self.wfile.write(b"data: " + json.dumps(event).encode() + b"\n\n")
                    self.wfile.flush()
                    event = next(events, None)
                self.wfile.write(b"data: [DONE]\n\n")
            except OSError:
                log.info("stream client went away")
                events.close()

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
            if body.get("stream"):
                self._stream(body)
                return
            try:
                self._reply(200, stack.chat_completion(body))
            except RequestError as e:
                self._reply(e.status, {"error": {"message": str(e)}})

        def log_message(self, fmt: str, *args: Any) -> None:
            log.debug("%s " + fmt, self.address_string(), *args)

    return ThreadingHTTPServer((host, port), Handler)
