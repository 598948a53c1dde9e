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
- ``GET /v1/models`` and ``GET /healthz`` (liveness, pages, queue depth,
  prefix-cache counters, under ``impl`` the engine's resolved execution
  modes, under ``init`` how the engine came up, and with the host KV tier
  its ``host_pool``), with the JAX package's bodies;
- the engine side of the fleet's data plane, in the JAX package's wire
  format (``fleet/transfer.py``): ``GET /fleet/digests`` (the replica's
  prefix digest), ``POST /fleet/park`` (park a token chain to host RAM),
  ``POST /fleet/kv/export`` (one chain ``{"tokens", "park"}`` or several
  ``{"chains": [{"tokens", "start_page"}], "park"}``), ``POST
  /fleet/kv/import`` (records into the host pool, checked first), ``POST
  /fleet/drain`` (a router's drain notice: the ``/healthz`` ``fleet`` block
  turns draining) and ``POST /fleet/promote`` (a router-side role change);
  a replica that joined a fleet (``make_server(..., membership=)``,
  ``fleet/client.py``) shows its membership under ``/healthz`` ``fleet``,
  and armed fault points under ``faults``;
- observability, with the JAX package's routes, status codes and bodies:
  ``GET /metrics`` (Prometheus text), ``/api/trace/{id}`` and
  ``/api/timeline/{id}`` (a completion's ``id`` is its trace's request
  id), ``/api/debug/flight?n=&kind=``, ``/api/slo``,
  ``/api/metrics/history?series=&since=&step=``; and under an
  operator-configured profile directory (``--profile-dir`` /
  ``OPSAGENT_PROFILE_DIR``, else 403): ``GET /api/debug/memory`` (the CUDA
  caching allocator's snapshot), ``POST /api/debug/profile?seconds=N`` (a
  ``torch.profiler`` Chrome trace of the next N seconds of live traffic),
  ``POST /v1/profile/start`` and ``/v1/profile/stop``.

Each request's life is a trace (``obs.trace``): the root span, a
``generate`` span per choice with the scheduler's ``queue_wait`` and the
engine's ``prefill`` and ``decode`` under it, then ``detokenize``. A body's
``fleet_hop`` (or ``X-Fleet-*`` headers) adopts the router's journey id,
as in the JAX package. Every request counts in
``opsagent_http_requests_total{method,path,status}`` and
``opsagent_http_request_duration_seconds{path}``, ``path`` being the
route's pattern.

HTTP handler threads touch CUDA only in the ``/fleet/*`` page copies, under
the engine lock: a stream reads the tokens that the scheduler thread puts
on a queue.

The in-process ``cuda://<name>`` provider (JAX's ``tpu://``): stacks
installed by name (``install_stack``), or built on first use with an engine
on the card (``get_stack``), answer the port's ``llm.ChatClient`` without
HTTP; importing this module registers the scheme. ``park_session`` is the
agent loop's tool-time signal to such a stack (``ServingStack.park``).
"""

from __future__ import annotations

import json
import logging
import os
import queue
import re
import threading
import time
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Iterator
from urllib.parse import parse_qs, urlsplit

from .. import obs
from ..llm.client import LLMError, register_provider
from ..utils import profiling
from ..utils.jsonrepair import parse_json
from .chat_template import apply_chat_template
from .constrained import JsonConstraint, device_table_fsm, json_constraint
from . import faults
from .engine import Engine, EngineConfig
from .fleet.transfer import pack_entries, unpack_entries
from .sampler import SamplingParams
from .scheduler import Request, RequestError, Scheduler

log = logging.getLogger("opsagent_tpu_torch.api")

# Completion tokens when the request gives no max_tokens.
MAX_NEW_TOKENS_DEFAULT = 1024
# /v1/models' owned_by.
OWNED_BY = "opsagent-tpu-torch"


class _SpanFinisher:
    """Duck-types ``Trace.finish()`` for a nested fleet-hop leg span: the
    completion paths call ``owned.finish()`` in their finally blocks, and a
    leg span that never closed would extend to "now" forever in the
    assembled timeline."""

    def __init__(self, span: Any):
        self._span = span

    def finish(self) -> None:
        self._span.close()


class ServingStack:
    """Engine + scheduler + chat glue for one hosted model."""

    def __init__(self, engine: Engine,
                 engine_factory: Callable[[], Engine] | None = None):
        """``engine_factory``: how the scheduler rebuilds the engine if it
        fails persistently (``Scheduler._recover``); None fails the
        requests in flight instead."""
        self.model_name = engine.model_cfg.name
        self.scheduler = Scheduler(engine, engine_factory=engine_factory)
        self.scheduler.start()

    @property
    def engine(self) -> Engine:
        """The scheduler's engine: a restart replaces it."""
        return self.scheduler.engine

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

    # -- tracing -------------------------------------------------------------
    def _request_trace(
        self, hop: dict[str, Any] | None = None,
    ) -> tuple[Any, "obs.Span | None", str]:
        """Trace context for one chat completion: nest under the caller's
        current span when one is active, otherwise root a NEW trace whose
        request id doubles as the OpenAI completion id, so ``GET
        /api/trace/<completion id>`` finds it. Returns
        (owned_handle_or_None, parent_span, completion_id).

        ``hop`` is a fleet router's hop stamp ({request_id, hop, replica}):
        the incoming journey id is ADOPTED instead of minting one, so the
        spans, flight events and attribution of every participating replica
        key to one id; when this process already holds a trace under it,
        the new leg nests as a ``fleet_hop`` child of its root."""
        parent = obs.current_span()
        if parent is not None:
            return None, parent, f"chatcmpl-{uuid.uuid4().hex[:24]}"
        rid = str(hop.get("request_id") or "") if hop else ""
        hop_kind = str(hop.get("hop", "")) if hop else ""
        if rid:
            existing = obs.get_store().get(rid)
            if existing is not None:
                if hop_kind == "failover":
                    existing.anomalous = True
                leg = existing.root.start_child(
                    "fleet_hop", hop=hop_kind, replica=str(hop.get("replica", "")),
                )
                return _SpanFinisher(leg), leg, rid
        t = obs.Trace(rid or obs.new_request_id("chatcmpl"))
        if hop:
            t.root.set(hop=hop_kind, replica=str(hop.get("replica", "")))
            # A failover leg IS the anomaly: tail-based retention keeps it.
            if hop_kind == "failover":
                t.anomalous = True
        obs.get_store().add(t)
        return t, t.root, t.request_id

    @staticmethod
    def _stamp_class(parent: "obs.Span | None", body: Any) -> None:
        """Stamp the request's SLO class on its trace (first writer
        wins)."""
        t = getattr(parent, "trace", None)
        if t is not None and not getattr(t, "slo_class", ""):
            t.slo_class = obs.slo.classify(body)

    def chat_completion(self, body: dict[str, Any]) -> dict[str, Any]:
        """One OpenAI chat completion of ``n`` choices (no streaming): ``n``
        requests of one prompt (the prefix cache shares its pages), each
        with its own constraint instance (a ``JsonConstraint`` walks one
        sequence's DFA); usage sums their tokens. Traced: see
        ``_request_trace``."""
        hop = body.pop("fleet_hop", None)
        owned, parent, cid = self._request_trace(hop)
        self._stamp_class(parent, body)
        try:
            return self._chat_completion_traced(body, parent, cid)
        finally:
            if owned is not None:
                owned.finish()

    def _chat_completion_traced(
        self, body: dict[str, Any], parent: "obs.Span | None", cid: str
    ) -> dict[str, Any]:
        sampling, prompt_ids, mask_fn = self._translate(body)
        n = self._choices(body)
        if not 1 <= n <= 8:
            raise RequestError("n must be in 1..8", 400)
        created = int(time.time())
        mask_fns = [mask_fn] + [self._constraint_from(body) for _ in range(n - 1)]
        spans = [parent.start_child("generate", choice=i) if parent is not None else None
                 for i in range(n)]
        reqs = [self.scheduler.submit(Request(list(prompt_ids), sampling, mask_fn=m,
                                              trace=spans[i]))
                for i, m in enumerate(mask_fns)]
        deadline = time.monotonic() + 600
        try:
            for req in reqs:
                if not req.done.wait(max(0.0, deadline - time.monotonic())):
                    raise RequestError("generation timed out", 504)
        finally:
            for span, req in zip(spans, reqs):
                if span is not None:
                    span.close(tokens=len(req.tokens))
        for req in reqs:
            if req.error:
                raise RequestError(req.error, req.error_status)
        completion = sum(len(r.tokens) for r in reqs)
        with obs.span("detokenize", parent=parent):
            choices = [self._build_choice(i, r, sampling) for i, r in enumerate(reqs)]
        return {
            "id": cid,
            "object": "chat.completion",
            "created": created,
            "model": body.get("model") or self.model_name,
            "choices": choices,
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
        hop = body.pop("fleet_hop", None)
        sampling, prompt_ids, mask_fn = self._translate(body)
        if sampling.logprobs:
            raise RequestError("logprobs are not supported with stream: true", 400)
        if self._choices(body) != 1:
            raise RequestError("n > 1 is not supported with stream", 400)
        token_q: "queue.Queue[int | None]" = queue.Queue()
        owned, parent, cid = self._request_trace(hop)
        self._stamp_class(parent, body)
        gen_span = parent.start_child("generate", stream=True) if parent is not None else None
        req = self.scheduler.submit(
            Request(prompt_ids, sampling, mask_fn=mask_fn, on_token=token_q.put,
                    trace=gen_span)
        )
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

        try:
            yield from self._stream_events(req, token_q, chunk, sampling)
        finally:
            # However the stream ends (a client going away closes the
            # generator here), the trace keeps whatever phases ran.
            if gen_span is not None:
                gen_span.close(tokens=len(req.tokens))
            if owned is not None:
                owned.finish()

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
        """``GET /healthz``: the JAX package's keys (the scheduler's queue
        depth is what a fleet router's spill-over reads)."""
        eng, sched = self.engine, self.scheduler
        with eng.lock:
            body = {
                "status": "ok",
                "model": self.model_name,
                "free_pages": eng.alloc.free_pages,
                "running": len(eng.sequences),
                "queued": len(sched._waiting) + sched._queue.qsize(),
                "prefilling": len(sched._prefilling),
                "prefix_hit_tokens": eng.alloc.hit_tokens,
                "prefix_miss_tokens": eng.alloc.miss_tokens,
                "prefix_evictions": eng.alloc.evictions,
                "impl": eng.impl_info(),
            }
            # Cold-start provenance: weights and warmup seconds, and
            # whether the engine came up fresh or from a snapshot.
            body["init"] = dict(eng.init_stats)
            if eng.offload is not None:
                body["host_pool"] = eng.offload.stats()
            if eng.cfg.async_depth > 1:
                body["async"] = {"depth": eng.cfg.async_depth,
                                 "inflight": eng.async_pending()}
            return body

    # -- host KV tier and the fleet's data plane -----------------------------
    def park(self, messages: list[dict[str, Any]], tools: Any = None) -> int:
        """Tool-time parking: tokenize the session's history as admission
        would and park its KV chain (copy the trie-resident pages to the
        host pool, free the HBM) while the agent's tool runs; the next
        turn restores the chain with a page copy. Returns tokens parked
        (0 with the host tier off: the call is always safe)."""
        eng = self.engine
        if eng.offload is None:
            return 0
        try:
            ids = apply_chat_template(eng.tokenizer, messages or [],
                                      model_family=self.model_name, tools=tools)
        except Exception:  # noqa: BLE001 - parking is best-effort
            return 0
        return eng.park_chain(ids)

    def fleet_digests(self) -> dict[str, Any]:
        eng = self.engine
        return {"model": self.model_name, "page_size": int(eng.cfg.page_size),
                "digests": eng.prefix_digests()}

    def fleet_park(self, tokens: list[int]) -> int:
        eng = self.engine
        n = eng.park_chain(tokens)
        eng.offload_flush()
        return n

    def fleet_export(self, reqs: list[tuple[list[int], int]], park: bool) -> list[list[dict]] | None:
        """Each (tokens, start_page) chain's host-pool pages as transfer
        records, after parking it (``park``: the sender hands the session
        off) or copying its trie pages without evicting them (a peer's
        fault-in must not cost this replica its cache). None with the host
        tier off."""
        eng = self.engine
        if eng.offload is None:
            return None
        out = []
        for tokens, start_page in reqs:
            if park:
                eng.park_chain(tokens)
                eng.offload_flush()
            else:
                eng.replicate_chain(tokens)
            out.append(pack_entries(eng.offload.pool.match(tokens, start_page=start_page)))
        return out

    def fleet_import(self, records: list[dict[str, Any]]) -> int | None:
        """Checked transfer records into the host pool; returns pages
        imported (None with the host tier off)."""
        eng = self.engine
        if eng.offload is None:
            return None
        return sum(1 for toks, tree in unpack_entries(records, eng.cache)
                   if eng.offload.pool.put(toks, tree))

    def models(self) -> dict[str, Any]:
        return {
            "object": "list",
            "data": [{"id": self.model_name, "object": "model", "owned_by": OWNED_BY}],
        }

    def metrics_text(self) -> str:
        """The ``/metrics`` document, the engine's gauges freshened first:
        page residency changes while the engine idles."""
        with self.engine.lock:
            self.engine._observe_occupancy()
        return obs.metrics_text()


# -- in-process cuda:// provider ------------------------------------------------
_stacks: dict[str, ServingStack] = {}
_stacks_lock = threading.Lock()


def install_stack(name: str, stack: ServingStack) -> None:
    """Serve ``stack`` under ``cuda://<name>`` (tests, co-hosting)."""
    with _stacks_lock:
        _stacks[name] = stack


def uninstall_stack(name: str) -> None:
    """Remove an installed stack (its owner closes it)."""
    with _stacks_lock:
        _stacks.pop(name, None)


def _installed(name: str) -> ServingStack | None:
    """The stack installed under ``name``, matched without case as a
    fallback (the agent's token budgeting lowercases model names)."""
    with _stacks_lock:
        stack = _stacks.get(name)
        if stack is None:
            low = name.lower()
            stack = next((s for k, s in _stacks.items() if k.lower() == low), None)
    return stack


def installed_stack_max_position(name: str) -> int | None:
    """The context window of a stack already installed under ``name``, or
    None; never builds an engine."""
    stack = _installed(name)
    return None if stack is None else int(stack.engine.model_cfg.max_position)


def park_session(model: str, messages: list[dict[str, Any]], tools: Any = None) -> int:
    """The agent loop's tool-time signal: park the session's KV to the host
    tier while the tool runs (``ServingStack.park``). ``model`` may carry
    its scheme (``cuda://``; JAX's ``tpu://`` is taken too). Looks up an
    installed stack only, never builds an engine, and never raises."""
    stack = _installed(model.split("://", 1)[-1])
    if stack is None:
        return 0
    try:
        return stack.park(messages, tools=tools)
    except Exception:  # noqa: BLE001 - parking is an optimization
        log.exception("tool-time parking failed (ignored)")
        return 0


def get_stack(name: str) -> ServingStack:
    """The stack of ``cuda://<name>``: the installed one, or a new one over
    an engine of preset ``name`` built on the card (default device) and
    warmed up. Built under the lock, so that two first requests do not
    build two."""
    with _stacks_lock:
        if name not in _stacks:
            log.info("creating an in-process engine for cuda://%s", name)
            engine = Engine(EngineConfig(model=name))
            engine.warmup()
            _stacks[name] = ServingStack(engine)
        return _stacks[name]


def _cuda_provider_factory(target: str):
    def provider(body: dict[str, Any]) -> dict[str, Any]:
        stack = get_stack(target or body.get("model", ""))
        try:
            return stack.chat_completion(body)
        except Exception as e:  # noqa: BLE001 - the agent loop handles LLMError
            raise LLMError(f"cuda engine error: {e}") from e

    return provider


register_provider("cuda", _cuda_provider_factory)


# (method, path pattern, handler): the JAX package's engine routes
# (``build_engine_app``). A pattern's ``{name}`` matches one path segment.
ROUTES = (
    ("POST", "/v1/chat/completions", "completions"),
    ("GET", "/v1/models", "models"),
    ("GET", "/healthz", "healthz"),
    ("GET", "/metrics", "metrics"),
    ("GET", "/api/trace/{request_id}", "trace_get"),
    ("GET", "/api/timeline/{request_id}", "timeline_get"),
    ("GET", "/api/debug/flight", "flight_get"),
    ("GET", "/api/debug/memory", "memory_profile"),
    ("GET", "/api/slo", "slo_get"),
    ("GET", "/api/metrics/history", "history_get"),
    ("POST", "/api/debug/profile", "profile_capture"),
    ("POST", "/v1/profile/start", "profile_start"),
    ("POST", "/v1/profile/stop", "profile_stop"),
    ("GET", "/fleet/digests", "fleet_digests"),
    ("POST", "/fleet/park", "fleet_park"),
    ("POST", "/fleet/kv/export", "fleet_kv_export"),
    ("POST", "/fleet/kv/import", "fleet_kv_import"),
    ("POST", "/fleet/drain", "fleet_drain"),
    ("POST", "/fleet/promote", "fleet_promote"),
)


def compile_routes(routes: tuple[tuple[str, str, str], ...]) -> list[tuple[str, str, re.Pattern, str]]:
    """(method, pattern, regex, handler) for each route; a pattern's
    ``{name}`` matches one path segment. The agent server
    (``server/app.py``) shares this with the engine's."""
    return [
        (method, pattern, re.compile("^" + re.sub(r"\{(\w+)\}", r"(?P<\1>[^/]+)", pattern) + "$"),
         handler)
        for method, pattern, handler in routes
    ]


def find_route(compiled: list, method: str, path: str) -> tuple[str | None, dict[str, str], str]:
    """(handler, path parameters, pattern) of the route ``method path``
    takes; the handler is None when the path matches only under another
    method (405), the pattern ``unmatched`` when no route has the path
    (404)."""
    label = "unmatched"
    for m, pattern, regex, handler in compiled:
        match = regex.match(path)
        if match is None:
            continue
        label = pattern
        if m == method:
            return handler, match.groupdict(), pattern
    return None, {}, label


_COMPILED = compile_routes(ROUTES)
_PROFILE_OFF = "profiling not enabled: start the server with --profile-dir"


class ObsRoutes:
    """The observability routes both HTTP servers answer, with the JAX
    package's status codes: ``/api/trace/{id}``, ``/api/timeline/{id}``,
    ``/api/debug/flight``, ``/api/slo``, ``/api/metrics/history``,
    ``/api/debug/memory`` and ``/api/debug/profile``. A server mixes this
    into its ``BaseHTTPRequestHandler`` and supplies ``_reply(status,
    payload)`` and ``_error(status, message)`` (the two servers' error
    bodies differ, as the JAX package's do), and may restate the class
    attributes below."""

    HISTORY_ERROR = "bad query: {}"          # the 400 of a bad history query
    PROFILE_OFF = _PROFILE_OFF               # the 403 of the memory route
    PROFILE_DENIED: tuple[type[BaseException], ...] = (profiling.ProfilingDisabled,)

    def trace_get(self, query: dict[str, str], request_id: str) -> None:
        t = obs.get_trace(request_id)
        if t is None:
            self._error(404, "unknown request_id")
        else:
            self._reply(200, t)

    def timeline_get(self, query: dict[str, str], request_id: str) -> None:
        tl = obs.timeline.assemble(request_id)
        if tl is None:
            self._error(404, "unknown request_id")
        else:
            self._reply(200, tl)

    def flight_get(self, query: dict[str, str]) -> None:
        try:
            n = int(query["n"]) if "n" in query else None
        except ValueError:
            self._error(400, "n must be an integer")
            return
        rec = obs.flight.get_recorder()
        self._reply(200, {**rec.stats(), "events": rec.snapshot(n=n, kind=query.get("kind"))})

    def slo_get(self, query: dict[str, str]) -> None:
        self._reply(200, obs.slo.evaluate())

    def history_get(self, query: dict[str, str]) -> None:
        try:
            kwargs = obs.history.parse_query(query)
        except ValueError as e:
            self._error(400, self.HISTORY_ERROR.format(e))
            return
        self._reply(200, obs.history.query(**kwargs))

    # -- profiling (operator-configured directory only) ----------------------
    def memory_profile(self, query: dict[str, str]) -> None:
        logdir = profiling.profile_dir()
        if not logdir:
            self._error(403, self.PROFILE_OFF)
            return
        stamp = time.strftime("%Y%m%dT%H%M%S", time.gmtime())
        path = os.path.join(logdir, f"memory-{stamp}.pickle")
        try:
            os.makedirs(logdir, exist_ok=True)
            profiling.save_device_memory_profile(path)
        except Exception as e:  # noqa: BLE001 - surfaced to the caller
            self._error(500, str(e))
            return
        self._reply(200, {"status": "saved", "path": path})

    def profile_capture(self, query: dict[str, str]) -> None:
        try:
            seconds = float(query.get("seconds", "5"))
        except ValueError:
            self._error(400, "seconds must be a number")
            return
        try:
            logdir = profiling.timed_capture(seconds)
        except ValueError as e:
            self._error(400, str(e))
            return
        except self.PROFILE_DENIED as e:
            self._error(403, str(e))
            return
        except Exception as e:  # noqa: BLE001 - a capture already running
            self._error(409, str(e))
            return
        self._reply(200, {"status": "captured", "seconds": seconds, "logdir": logdir})


def make_server(stack: ServingStack, host: str, port: int,
                membership: Any = None) -> ThreadingHTTPServer:
    """A threading HTTP server for ``stack`` bound to (host, port); port 0
    picks a free one (read it from ``server.server_address``).
    ``membership`` is the replica's fleet membership (``serve-engine
    --join-fleet``, ``fleet/client.py``): it feeds the ``/healthz`` ``fleet``
    block and takes ``/fleet/drain`` and ``/fleet/promote``."""

    class Handler(ObsRoutes, BaseHTTPRequestHandler):
        _status = 0

        def send_response(self, code: int, message: str | None = None) -> None:
            self._status = code
            super().send_response(code, message)

        def _reply(self, status: int, payload: dict[str, Any]) -> None:
            self._send(status, json.dumps(payload, default=str).encode(), "application/json")

        def _error(self, status: int, message: str) -> None:
            self._reply(status, {"error": {"message": message}})

        def _send(self, status: int, data: bytes, ctype: str, **headers: str) -> None:
            self.send_response(status)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(data)))
            for k, v in headers.items():
                self.send_header(k, v)
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

        # -- dispatch --------------------------------------------------------
        def _dispatch(self, method: str) -> None:
            url = urlsplit(self.path)
            query = {k: v[0] for k, v in parse_qs(url.query).items()}
            t0 = time.perf_counter()
            handler, params, label = find_route(_COMPILED, method, url.path)
            try:
                if handler is not None:
                    getattr(self, handler)(query, **params)
                elif label != "unmatched":
                    self._error(405, "method not allowed")
                else:
                    self._error(404, "not found")
            finally:
                obs.HTTP_REQUESTS.inc(method=method, path=label, status=str(self._status))
                obs.HTTP_LATENCY_SECONDS.observe(time.perf_counter() - t0, path=label)

        def do_GET(self) -> None:  # noqa: N802 - http.server's name
            self._dispatch("GET")

        def do_POST(self) -> None:  # noqa: N802 - http.server's name
            self._dispatch("POST")

        def _body(self) -> dict[str, Any] | None:
            """The request's JSON object, or None after a 400 reply."""
            try:
                length = int(self.headers.get("Content-Length", 0))
                body = json.loads(self.rfile.read(length) or b"{}")
                if not isinstance(body, dict):
                    raise ValueError("body must be a JSON object")
            except ValueError as e:
                self._reply(400, {"error": {"message": f"invalid JSON: {e}"}})
                return None
            return body

        # -- chat ------------------------------------------------------------
        def completions(self, query: dict[str, str]) -> None:
            body = self._body()
            if body is None:
                return
            # A fleet router stamps its journey in the body and as
            # X-Fleet-* headers; the headers survive a proxy that strips
            # unknown body fields.
            rid = self.headers.get("X-Fleet-Request-Id")
            if "fleet_hop" not in body and rid:
                body["fleet_hop"] = {
                    "request_id": rid,
                    "hop": self.headers.get("X-Fleet-Hop", ""),
                    "replica": self.headers.get("X-Fleet-Replica", ""),
                }
            if body.get("stream"):
                self._stream(body)
                return
            try:
                self._reply(200, stack.chat_completion(body))
            except RequestError as e:
                self._reply(e.status, {"error": {"message": str(e)}})

        def models(self, query: dict[str, str]) -> None:
            self._reply(200, stack.models())

        def healthz(self, query: dict[str, str]) -> None:
            body = stack.health()
            if membership is not None:
                body["fleet"] = membership.healthz_block()
            if faults.active():
                # Which fault points are armed and what has fired: injected
                # pain told apart from real pain.
                body["faults"] = faults.summary()
            self._reply(200, body)

        # -- observability ---------------------------------------------------
        def metrics(self, query: dict[str, str]) -> None:
            self._send(200, stack.metrics_text().encode(), "text/plain; charset=utf-8",
                       **{"X-Prometheus-Version": "0.0.4"})

        # -- profiling (operator-configured directory only) ------------------
        def profile_start(self, query: dict[str, str]) -> None:
            logdir = profiling.profile_dir()
            if not logdir:
                self._error(403, _PROFILE_OFF)
                return
            try:
                profiling.start_trace(logdir)
            except Exception as e:  # noqa: BLE001 - already tracing / bad dir
                self._reply(409, {"error": {"message": str(e)}})
                return
            self._reply(200, {"status": "tracing", "logdir": logdir})

        def profile_stop(self, query: dict[str, str]) -> None:
            try:
                profiling.stop_trace()
            except Exception as e:  # noqa: BLE001 - not tracing / write failure
                self._reply(409, {"error": {"message": str(e)}})
                return
            self._reply(200, {"status": "stopped"})

        # -- fleet data plane (the engine side) -------------------------------
        def fleet_digests(self, query: dict[str, str]) -> None:
            self._reply(200, stack.fleet_digests())

        def fleet_park(self, query: dict[str, str]) -> None:
            body = self._body()
            if body is None:
                return
            try:
                tokens = [int(t) for t in body.get("tokens") or []]
            except (TypeError, ValueError):
                self._reply(400, {"error": {"message": "tokens must be an int list"}})
                return
            self._reply(200, {"parked_tokens": stack.fleet_park(tokens)})

        def fleet_kv_export(self, query: dict[str, str]) -> None:
            # {"tokens": [...], "park": true}: one chain (migration);
            # {"chains": [{"tokens": [...], "start_page": N}], "park": false}:
            # several (a peer's page fault-in).
            body = self._body()
            if body is None:
                return
            batched = body.get("chains") is not None
            chains = body["chains"] if batched else [
                {"tokens": body.get("tokens") or [], "start_page": 0}]
            try:
                reqs = [([int(t) for t in c.get("tokens") or []],
                         max(0, int(c.get("start_page", 0)))) for c in chains]
            except (TypeError, ValueError, AttributeError):
                self._reply(400, {"error": {"message": "tokens must be an int list"}})
                return
            results = stack.fleet_export(reqs, bool(body.get("park", True)))
            page_size = int(stack.engine.cfg.page_size)
            if results is None:
                self._reply(200, {"results": [{"pages": []} for _ in reqs], "offload": False}
                            if batched else {"pages": [], "offload": False})
            elif batched:
                self._reply(200, {"results": [{"pages": p} for p in results],
                                  "page_size": page_size})
            else:
                self._reply(200, {"pages": results[0], "page_size": page_size})

        def fleet_kv_import(self, query: dict[str, str]) -> None:
            body = self._body()
            if body is None:
                return
            n = stack.fleet_import(body.get("pages") or [])
            self._reply(200, {"imported": 0, "offload": False} if n is None
                        else {"imported": n})

        def fleet_drain(self, query: dict[str, str]) -> None:
            # A router's drain notice: the /healthz fleet block turns
            # draining (the router stops routing here; work in flight
            # finishes).
            if membership is not None:
                membership.draining = True
            self._reply(200, {"status": "draining",
                              "running": len(stack.engine.sequences)})

        def fleet_promote(self, query: dict[str, str]) -> None:
            # A router-side role change (standby -> decode), kept in the
            # membership so that a later re-register carries it.
            try:
                length = int(self.headers.get("Content-Length", 0))
                body = json.loads(self.rfile.read(length) or b"{}")
            except ValueError:
                body = {}
            role = str((body if isinstance(body, dict) else {}).get("role", "decode"))
            if membership is not None:
                membership.promote(role)
            self._reply(200, {"status": "ok",
                              "role": membership.role if membership is not None else role})

        def log_message(self, fmt: str, *args: Any) -> None:
            log.debug("%s " + fmt, self.address_string(), *args)

    return ThreadingHTTPServer((host, port), Handler)
