"""OpenAI-compatible HTTP front end for the port's serving engine (the
counterpart of ``opsagent_tpu/serving/api.py``).

``ServingStack`` glues the engine, the scheduler and the chat template;
``make_server`` serves it with the standard library's threading HTTP
server:

- ``POST /v1/chat/completions``: OpenAI chat completion with the JAX
  package's fields and limits: ``tools`` (in the prompt, unless
  ``tool_choice`` is ``"none"``) and a ``tool_calls`` reply;
  ``tool_choice`` ``"required"`` or a named function (constrained decoding
  of a ``tool_calls`` envelope); ``response_format`` (``json_object``,
  ``json_schema``); ``logit_bias``, presence and frequency penalties;
  ``logprobs`` with ``top_logprobs``; ``n`` choices (1..8); ``stream:
  true`` (server-sent events, ``data: [DONE]`` last; not with logprobs or
  ``n`` > 1). A field out of its limits answers 400 naming it;
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

from ..utils.jsonrepair import parse_json
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
        logprobs = bool(body.get("logprobs", False))
        top_lp = int(body.get("top_logprobs", 0) or 0)
        if top_lp and not logprobs:
            raise ValueError("top_logprobs requires logprobs: true")
        if not 0 <= top_lp <= 20:
            raise ValueError("top_logprobs must be in 0..20")
        lb_raw = body.get("logit_bias") or {}
        if not isinstance(lb_raw, dict):
            raise ValueError("logit_bias must be an object of id -> bias")
        logit_bias = []
        for k, v in lb_raw.items():
            b = float(v)
            if not -100.0 <= b <= 100.0:
                raise ValueError("logit_bias values must be in -100..100")
            logit_bias.append((int(k), b))
        pres = float(body.get("presence_penalty", 0.0) or 0.0)
        freq = float(body.get("frequency_penalty", 0.0) or 0.0)
        if not -2.0 <= pres <= 2.0 or not -2.0 <= freq <= 2.0:
            raise ValueError("penalties must be in -2..2")
        stop = body.get("stop") or []
        return SamplingParams(
            temperature=float(body.get("temperature", 0.0) or 0.0),
            top_k=int(body.get("top_k", 0) or 0),
            top_p=float(body.get("top_p", 1.0) or 1.0),
            max_tokens=int(body.get("max_tokens") or MAX_NEW_TOKENS_DEFAULT),
            stop=(stop,) if isinstance(stop, str) else tuple(stop),
            logprobs=logprobs,
            top_logprobs=top_lp,
            logit_bias=tuple(logit_bias),
            presence_penalty=pres,
            frequency_penalty=freq,
        )

    def _tool_choice_constraint(self, body: dict[str, Any]) -> JsonConstraint | None:
        """OpenAI ``tool_choice`` -> a constraint forcing a ``tool_calls``
        envelope: ``"required"`` a call of any listed tool, ``{"type":
        "function", "function": {"name": N}}`` a call of N, its arguments
        under the tool's parameter schema where the compiler takes it and
        any JSON where it does not (the JAX package's rule)."""
        tc = body.get("tool_choice")
        tools = body.get("tools") or []
        if tc in (None, "auto", "none"):
            return None
        names = [
            t.get("function", {}).get("name")
            for t in tools
            if isinstance(t, dict) and t.get("function", {}).get("name")
        ]
        if not names:
            raise ValueError("tool_choice requires a non-empty tools list")
        args_schema: Any = {}
        if tc == "required":
            name_schema: dict[str, Any] = {"enum": names}
        elif isinstance(tc, dict) and tc.get("type") == "function":
            want = tc.get("function", {}).get("name")
            if want not in names:
                raise ValueError(f"tool_choice names unknown function {want!r}")
            name_schema = {"enum": [want]}
            for t in tools:
                if isinstance(t, dict) and t.get("function", {}).get("name") == want:
                    args_schema = t["function"].get("parameters") or {}
        else:
            raise ValueError(f"unsupported tool_choice {tc!r}")

        def envelope(args: Any) -> dict[str, Any]:
            return {
                "type": "object",
                "properties": {
                    "tool_calls": {
                        "type": "array",
                        "minItems": 1,
                        "items": {
                            "type": "object",
                            "properties": {
                                "function": {
                                    "type": "object",
                                    "properties": {"name": name_schema, "arguments": args},
                                },
                            },
                        },
                    },
                },
            }

        # depth=8: the envelope takes 4 nesting levels (object -> array ->
        # item -> function), so at the default depth "arguments" would
        # compile at depth 0, primitives only.
        try:
            return json_constraint(self.engine.tokenizer, envelope(args_schema), depth=8)
        except ValueError:
            # A parameter schema outside the compiler's subset: the
            # envelope and the name are still forced, the arguments are
            # any JSON.
            return json_constraint(self.engine.tokenizer, envelope({}), depth=8)

    def _constraint_from(self, body: dict[str, Any]) -> JsonConstraint | None:
        """OpenAI ``response_format`` or a forcing ``tool_choice`` ->
        constrained-decoding mask_fn: ``json_object`` constrains to any
        JSON value, ``json_schema`` to the given schema. Both at once, an
        unknown type, a malformed schema or one whose DFA is over the
        limit raises ValueError."""
        rf = body.get("response_format")
        mask_fn = self._tool_choice_constraint(body)
        if rf and mask_fn is not None:
            raise ValueError(
                "response_format and a forcing tool_choice cannot be "
                "combined (one constrained-decoding grammar per request)"
            )
        if rf:
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
        if mask_fn is not None:
            # The dense device tables, where they fit, are built here on
            # the handler's thread rather than on the scheduler's.
            device_table_fsm(mask_fn)
        return mask_fn

    def _prompt_ids(self, body: dict[str, Any]) -> list[int]:
        # tool_choice "none": the model must not see the tools at all.
        tools = None if body.get("tool_choice") == "none" else body.get("tools")
        return apply_chat_template(
            self.engine.tokenizer, body.get("messages", []),
            model_family=self.model_name, tools=tools,
        )

    def _translate(
        self, body: dict[str, Any]
    ) -> tuple[SamplingParams, list[int], JsonConstraint | None]:
        """(sampling, prompt ids, mask_fn) of a request; a malformed one
        raises RequestError 400."""
        try:
            return self._sampling_from(body), self._prompt_ids(body), self._constraint_from(body)
        except (ValueError, TypeError, KeyError) as e:
            raise RequestError(f"invalid request: {e}", 400) from e

    @staticmethod
    def _choices(body: dict[str, Any]) -> int:
        try:
            return int(body.get("n", 1) or 1)
        except (TypeError, ValueError) as e:
            raise RequestError(f"invalid n: {e}", 400) from e

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

    @staticmethod
    def _parse_tool_calls(text: str) -> list[dict[str, Any]] | None:
        """The calls of a reply that is a ``{"tool_calls": [...]}`` object
        (repaired by ``parse_json`` where it is sloppy), or None."""
        t = text.strip()
        if '"tool_calls"' not in t:
            return None
        try:
            obj = parse_json(t)
        except ValueError:
            return None
        calls = obj.get("tool_calls") if isinstance(obj, dict) else None
        if not isinstance(calls, list) or not calls:
            return None
        out = []
        for i, c in enumerate(calls):
            fn = c.get("function", {}) if isinstance(c, dict) else {}
            args = fn.get("arguments", "")
            if not isinstance(args, str):
                args = json.dumps(args, ensure_ascii=False)
            out.append({
                "id": c.get("id") or f"call_{i}",
                "type": "function",
                "function": {"name": fn.get("name", ""), "arguments": args},
            })
        return out

    def _build_choice(
        self, index: int, req: Request, sampling: SamplingParams
    ) -> dict[str, Any]:
        """One choice: the text, or ``tool_calls`` with finish_reason
        "tool_calls" when the reply is a call; with ``logprobs``, one entry
        per token of the text as it stands after the stop-string cut."""
        tokens = req.tokens
        text, finish = self._finalize_text(tokens, sampling.stop, req.finish_reason)
        message: dict[str, Any] = {"role": "assistant", "content": text}
        tool_calls = self._parse_tool_calls(text)
        if tool_calls:
            message = {"role": "assistant", "content": None, "tool_calls": tool_calls}
            finish = "tool_calls"
        choice: dict[str, Any] = {"index": index, "message": message, "finish_reason": finish}
        if sampling.logprobs:
            tok = self.engine.tokenizer
            lp_toks = tokens[:-1] if tokens and tokens[-1] == tok.eos_id else tokens
            if finish == "stop" and sampling.stop:
                # Keep the tokens whose decode fits before the stop
                # string's start: a token the cut splits is dropped, so
                # the entries never run past the content.
                full = tok.decode(lp_toks)
                hits = [h for h in (full.find(s) for s in sampling.stop) if h >= 0]
                if hits:
                    cut, keep = min(hits), 0
                    for n in range(1, len(lp_toks) + 1):
                        if len(tok.decode(lp_toks[:n])) > cut:
                            break
                        keep = n
                    lp_toks = lp_toks[:keep]
            choice["logprobs"] = {
                "content": [
                    {
                        # token_str, not decode([t]): decode skips specials
                        # and mangles half of a multi-byte character.
                        "token": tok.token_str(t),
                        "logprob": d["logprob"],
                        "top_logprobs": [
                            {"token": tok.token_str(i), "logprob": lp} for i, lp in d["top"]
                        ],
                    }
                    for t, d in zip(lp_toks, req.logprob_data)
                ]
            }
        return choice

    def chat_completion(self, body: dict[str, Any]) -> dict[str, Any]:
        """One OpenAI chat completion of ``n`` choices (no streaming): ``n``
        requests of one prompt (the prefix cache shares its pages), each
        with its own constraint instance (a ``JsonConstraint`` walks one
        sequence's DFA); usage sums their tokens."""
        sampling, prompt_ids, mask_fn = self._translate(body)
        n = self._choices(body)
        if not 1 <= n <= 8:
            raise RequestError("n must be in 1..8", 400)
        created = int(time.time())
        mask_fns = [mask_fn] + [self._constraint_from(body) for _ in range(n - 1)]
        reqs = [self.scheduler.submit(Request(list(prompt_ids), sampling, mask_fn=m))
                for m in mask_fns]
        deadline = time.monotonic() + 600
        for req in reqs:
            if not req.done.wait(max(0.0, deadline - time.monotonic())):
                raise RequestError("generation timed out", 504)
        for req in reqs:
            if req.error:
                raise RequestError(req.error, req.error_status)
        completion = sum(len(r.tokens) for r in reqs)
        return {
            "id": f"chatcmpl-{uuid.uuid4().hex[:24]}",
            "object": "chat.completion",
            "created": created,
            "model": body.get("model") or self.model_name,
            "choices": [self._build_choice(i, r, sampling) for i, r in enumerate(reqs)],
            "usage": {
                "prompt_tokens": len(prompt_ids),
                "completion_tokens": completion,
                "total_tokens": len(prompt_ids) + completion,
            },
            "ttft_s": reqs[0].ttft_s,
        }

    def chat_completion_stream(self, body: dict[str, Any]) -> Iterator[dict[str, Any]]:
        """One chat completion as a generator of SSE chunk dicts. Nothing
        is yielded until the admission's outcome is known: a request that
        fails admission raises RequestError from the first ``next``, so the
        server answers it with an HTTP status, not a 200 stream. Neither
        logprobs nor ``n`` > 1 streams: both answer 400."""
        sampling, prompt_ids, mask_fn = self._translate(body)
        if sampling.logprobs:
            raise RequestError("logprobs are not supported with stream: true", 400)
        if self._choices(body) != 1:
            raise RequestError("n > 1 is not supported with stream", 400)
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
