"""Constrained decoding: JSON schema -> byte DFA -> token-level logit masks
(the port's copy of the numpy path of ``opsagent_tpu/serving/constrained.py``).

The agent asks for JSON on every turn (the ReAct ToolPrompt, the fan-out
findings). The engine masks each step's logits so that the model can only
emit bytes that a JSON schema's automaton accepts.

1. A small regex AST (byte sets, sequence, alternation, repetition) goes
   through Thompson construction and subset construction to a byte DFA.
   JSON nests without bound; bounding the depth (4 for a schemaless
   ``json_object``) makes the language regular.
2. ``TokenFSM`` lifts the DFA to the tokenizer's vocabulary: a token is
   admissible in a state when every one of its bytes survives the DFA.
   Within ``NATIVE_TABLE_BUDGET`` the C++ matcher (``opsagent_tpu_torch.
   native``) precomputes every state's mask and destination at once, and
   host masks and advances read its tables; past it they are computed per
   state on demand and cached. ``dense_tables`` builds the full ``[states
   + 1, vocab]`` mask and destination tables that the engine keeps on the
   device and steps inside its captured decode step, from the numpy walk.
3. ``JsonConstraint`` is the engine-facing ``mask_fn``: given the generated
   tokens it returns the ``[vocab]`` bool mask. EOS is admissible exactly
   in accepting states.

4. Forced runs (grammar fast-forward): a state whose mask admits exactly
   one token forces it at any temperature, so the engine may append a
   whole run of forced tokens in one forward (``TokenFSM.forced_run``,
   ``JsonConstraint.forced_run``).
"""

from __future__ import annotations

import json
import threading
from dataclasses import dataclass, field
from typing import Any, Iterable

import numpy as np

# -- regex AST --------------------------------------------------------------
# Nodes: ("lit", frozenset[int]) | ("seq", [n...]) | ("alt", [n...])
#        | ("star", n) | ("opt", n) | ("plus", n)

Node = tuple


def lit(chars: Iterable[int] | bytes | str) -> Node:
    if isinstance(chars, str):
        chars = chars.encode("utf-8")
    return ("lit", frozenset(chars))


def text(s: str) -> Node:
    return ("seq", [lit(bytes([b])) for b in s.encode("utf-8")])


def seq(*nodes: Node) -> Node:
    return ("seq", list(nodes))


def alt(*nodes: Node) -> Node:
    return ("alt", list(nodes))


def star(node: Node) -> Node:
    return ("star", node)


def opt(node: Node) -> Node:
    return ("opt", node)


def plus(node: Node) -> Node:
    return ("plus", node)


# -- NFA (Thompson) ---------------------------------------------------------
@dataclass
class _NFA:
    # transitions[state] = list of (byteset | None for epsilon, next_state)
    transitions: list[list[tuple[frozenset | None, int]]] = field(
        default_factory=list
    )

    def new_state(self) -> int:
        self.transitions.append([])
        return len(self.transitions) - 1

    def add(self, s: int, byteset: frozenset | None, t: int) -> None:
        self.transitions[s].append((byteset, t))


def _build(nfa: _NFA, node: Node) -> tuple[int, int]:
    """Compile a node; returns (start, end) NFA states."""
    kind = node[0]
    if kind == "lit":
        s, e = nfa.new_state(), nfa.new_state()
        nfa.add(s, node[1], e)
        return s, e
    if kind == "seq":
        s = e = nfa.new_state()
        for child in node[1]:
            cs, ce = _build(nfa, child)
            nfa.add(e, None, cs)
            e = ce
        return s, e
    if kind == "alt":
        s, e = nfa.new_state(), nfa.new_state()
        for child in node[1]:
            cs, ce = _build(nfa, child)
            nfa.add(s, None, cs)
            nfa.add(ce, None, e)
        return s, e
    if kind in ("star", "opt", "plus"):
        cs, ce = _build(nfa, node[1])
        s, e = nfa.new_state(), nfa.new_state()
        nfa.add(s, None, cs)
        if kind != "plus":
            nfa.add(s, None, e)
        nfa.add(ce, None, e)
        if kind != "opt":
            nfa.add(ce, None, cs)
        return s, e
    raise ValueError(f"unknown regex node {kind!r}")


# -- DFA (subset construction) ----------------------------------------------
@dataclass
class ByteDFA:
    """Dense byte-level DFA: next[state*256 + byte] -> state or -1 (dead)."""

    next: np.ndarray          # [num_states * 256] int32
    accept: np.ndarray        # [num_states] bool
    start: int = 0

    @property
    def num_states(self) -> int:
        return len(self.accept)

    def step(self, state: int, byte: int) -> int:
        if state < 0:
            return -1
        return int(self.next[state * 256 + byte])

    def run(self, state: int, data: bytes) -> int:
        for b in data:
            state = self.step(state, b)
            if state < 0:
                return -1
        return state


def compile_regex(node: Node) -> ByteDFA:
    nfa = _NFA()
    start, end = _build(nfa, node)

    def eclose(states: frozenset[int]) -> frozenset[int]:
        stack, seen = list(states), set(states)
        while stack:
            s = stack.pop()
            for byteset, t in nfa.transitions[s]:
                if byteset is None and t not in seen:
                    seen.add(t)
                    stack.append(t)
        return frozenset(seen)

    start_set = eclose(frozenset([start]))
    state_ids: dict[frozenset, int] = {start_set: 0}
    worklist = [start_set]
    rows: list[np.ndarray] = []
    accept: list[bool] = []
    while worklist:
        cur = worklist.pop()
        sid = state_ids[cur]
        while len(rows) <= sid:
            rows.append(np.full((256,), -1, np.int32))
            accept.append(False)
        accept[sid] = end in cur
        # Group reachable targets per byte.
        per_byte: dict[int, set[int]] = {}
        for s in cur:
            for byteset, t in nfa.transitions[s]:
                if byteset is None:
                    continue
                for b in byteset:
                    per_byte.setdefault(b, set()).add(t)
        for b, targets in per_byte.items():
            tset = eclose(frozenset(targets))
            if tset not in state_ids:
                state_ids[tset] = len(state_ids)
                worklist.append(tset)
            rows[sid][b] = state_ids[tset]
    # The worklist may have appended rows out of order; normalize.
    n = len(state_ids)
    nxt = np.full((n, 256), -1, np.int32)
    acc = np.zeros((n,), bool)
    for sid in state_ids.values():
        if sid < len(rows):
            nxt[sid] = rows[sid]
            acc[sid] = accept[sid]
    return ByteDFA(next=nxt.reshape(-1), accept=acc, start=0)


# -- JSON schema -> regex ---------------------------------------------------
# Whitespace between tokens, at most 2 characters: an unbounded run would
# let a degenerate decode spend its budget on "\n\n\n..." and inflate the
# DFA. This shapes what is generated, not what parses.
_WS = seq(opt(lit(b" \t\n\r")), opt(lit(b" \t\n\r")))

# String body: any byte except '"', '\' and C0 controls, or an escape.
_STRING_CHAR = lit(frozenset(range(0x20, 0x100)) - {0x22, 0x5C})
_ESCAPE = seq(
    lit(b"\\"),
    alt(
        lit(b'"\\/bfnrt'),
        seq(lit(b"u"), *([lit(b"0123456789abcdefABCDEF")] * 4)),
    ),
)
_STRING = seq(lit(b'"'), star(alt(_STRING_CHAR, _ESCAPE)), lit(b'"'))
_NUMBER = seq(
    opt(lit(b"-")),
    alt(lit(b"0"), seq(lit(b"123456789"), star(lit(b"0123456789")))),
    opt(seq(lit(b"."), plus(lit(b"0123456789")))),
    opt(seq(lit(b"eE"), opt(lit(b"+-")), plus(lit(b"0123456789")))),
)
_BOOL = alt(text("true"), text("false"))
_NULL = text("null")


def _json_value(depth: int) -> Node:
    """Any JSON value with nesting bounded at ``depth``."""
    leaves = [_STRING, _NUMBER, _BOOL, _NULL]
    if depth <= 0:
        return alt(*leaves)
    inner = _json_value(depth - 1)
    obj = seq(
        lit(b"{"), _WS,
        opt(seq(
            _STRING, _WS, lit(b":"), _WS, inner,
            star(seq(_WS, lit(b","), _WS, _STRING, _WS, lit(b":"), _WS, inner)),
        )),
        _WS, lit(b"}"),
    )
    arr = seq(
        lit(b"["), _WS,
        opt(seq(inner, star(seq(_WS, lit(b","), _WS, inner)))),
        _WS, lit(b"]"),
    )
    return alt(*leaves, obj, arr)


def schema_to_regex(schema: dict[str, Any] | None, depth: int = 4) -> Node:
    """JSON-schema subset -> regex. Supported: type object (properties in
    declaration order, all listed properties required), string, number,
    integer, boolean, null, array (items), enum (of strings), and {} / None
    meaning "any JSON value"."""
    if not schema:
        return _json_value(depth)
    if "enum" in schema:
        return alt(*(text(json_quote(v)) for v in schema["enum"]))
    t = schema.get("type")
    if t == "object" or (t is None and "properties" in schema):
        props = schema.get("properties", {})
        if not props:
            return _json_value(depth)
        parts: list[Node] = [lit(b"{"), _WS]
        for i, (key, sub) in enumerate(props.items()):
            if i:
                parts += [_WS, lit(b","), _WS]
            parts += [
                text(f'"{key}"'), _WS, lit(b":"), _WS,
                schema_to_regex(sub, depth - 1),
            ]
        parts += [_WS, lit(b"}")]
        return seq(*parts)
    if t == "array":
        inner = schema_to_regex(schema.get("items"), depth - 1)
        rest = star(seq(_WS, lit(b","), _WS, inner))
        body = seq(inner, rest)
        if not schema.get("minItems"):
            body = opt(body)  # minItems >= 1 forbids the empty array
        return seq(lit(b"["), _WS, body, _WS, lit(b"]"))
    if t == "string":
        return _STRING
    if t in ("number", "integer"):
        return _NUMBER
    if t == "boolean":
        return _BOOL
    if t == "null":
        return _NULL
    return _json_value(depth)


def json_quote(value: Any) -> str:
    return json.dumps(value)


# -- Token-level FSM --------------------------------------------------------
# Dense [states + 1, vocab] tables live on the device, and the native
# [states, vocab] tables on the host, only within this many entries: a
# schemaless json_object DFA has ~15k states, which at a 128k vocab would be
# gigabytes from one request. Larger FSMs mask on the host, per state
# visited.
NATIVE_TABLE_BUDGET = 64_000_000

# Longest forced run one fast-forward append carries: it bounds the walk (a
# cyclic grammar could force forever) and the append's q_len, which must fit
# a mixed bucket.
FORCED_RUN_CAP = 12


class TokenFSM:
    """Lifts a byte DFA to token-level masks over a tokenizer vocabulary.

    Within ``NATIVE_TABLE_BUDGET`` entries, the native tables
    (``NativeFSMTables``, built when the FSM is; a failed build raises)
    answer every host mask and advance. Past it, host masks are computed
    per DFA state on demand and cached, each one vectorized over the
    vocabulary (token bytes packed into a dense ``[vocab, maxlen]`` matrix,
    advanced one byte position per numpy op), so a cold state costs
    milliseconds even at 128k tokens."""

    def __init__(self, dfa: ByteDFA, token_bytes: list[bytes], eos_id: int):
        self.dfa = dfa
        self.token_bytes = token_bytes
        self.eos_id = eos_id
        self.vocab_size = len(token_bytes)
        self._mask_cache: dict[int, np.ndarray] = {}
        self._dense: tuple[np.ndarray, np.ndarray] | None = None
        self._forced: dict[int, int | None] = {}
        self._forced_runs: dict[int, list[int]] = {}
        self._forced_table: tuple[np.ndarray, np.ndarray] | None = None
        self._lens = np.array([len(tb) for tb in token_bytes], np.int32)
        maxlen = max(1, int(self._lens.max()))
        self._bytes = np.zeros((self.vocab_size, maxlen), np.int32)
        for tid, tb in enumerate(token_bytes):
            if tb:
                self._bytes[tid, : len(tb)] = np.frombuffer(tb, np.uint8)
        # The native tables within the budget, as the JAX package takes
        # them (without its fallback: the build's failure is the caller's).
        self._native = None
        if dfa.num_states * self.vocab_size <= NATIVE_TABLE_BUDGET:
            from ..native import NativeFSMTables

            self._native = NativeFSMTables(dfa.next, dfa.accept, token_bytes, eos_id)

    def _walk(self, state: int) -> tuple[np.ndarray, np.ndarray]:
        """The vectorized byte walk: ([V] allow-mask, [V] final DFA state)
        from one source state. The one source of the host masks and of the
        dense device tables."""
        nxt = self.dfa.next
        st = np.full((self.vocab_size,), state, np.int32)
        alive = self._lens > 0  # empty byte strings (specials) are forbidden
        for j in range(self._bytes.shape[1]):
            has = j < self._lens
            step = alive & has
            idx = np.where(step, st, 0) * 256 + self._bytes[:, j]
            st = np.where(step, nxt[idx], st)
            alive &= ~has | (st >= 0)
        mask = alive
        if self.dfa.accept[state]:
            mask = mask.copy()
            mask[self.eos_id] = True
        return mask, st

    def mask_for_state(self, state: int) -> np.ndarray:
        if self._native is not None:
            return self._native.mask_for_state(state)
        cached = self._mask_cache.get(state)
        if cached is not None:
            return cached
        mask = np.zeros((self.vocab_size,), bool)
        if state >= 0:
            mask, _ = self._walk(state)
        self._mask_cache[state] = mask
        return mask

    def advance(self, state: int, token_id: int) -> int:
        if self._native is not None:
            return self._native.advance(state, token_id)
        return self.dfa.run(state, self.token_bytes[token_id])

    def _mask_dest_row(self, state: int) -> tuple[np.ndarray, np.ndarray]:
        """One state's (allow-mask [V], destination [V]) for the device
        tables, from ``_walk``. A disallowed token's destination is 0 (the
        mask blocks it); EOS keeps the state (EOS ends generation and never
        advances the DFA). Seeds the host mask cache."""
        mask, st = self._walk(state)
        self._mask_cache.setdefault(state, mask)
        # Device numbering: DFA state s lives at row s + 1 (row 0 is the
        # FREE sentinel), so destinations shift by one.
        dest = np.where(mask, np.maximum(st, 0) + 1, 0).astype(np.int32)
        dest[self.eos_id] = state + 1
        return mask, dest

    def dense_tables(self) -> tuple[np.ndarray, np.ndarray] | None:
        """Full ([S+1, V] allow-mask, [S+1, V] dest) tables for stepping
        the FSM on the device inside the decode step, with no host sync per
        token. Row 0 is the FREE sentinel (everything allowed, dest 0), so
        unconstrained rows in the same batch ride at row 0 whichever
        schema's tables are loaded; DFA state s is row s+1. None when the
        tables exceed ``NATIVE_TABLE_BUDGET`` entries (the host masks still
        work). Built once and cached."""
        if self._dense is not None:
            return self._dense
        S, V = self.dfa.num_states, self.vocab_size
        if (S + 1) * V > NATIVE_TABLE_BUDGET:
            return None
        mask = np.zeros((S + 1, V), bool)
        dest = np.zeros((S + 1, V), np.int32)
        mask[0] = True
        for s in range(S):
            mask[s + 1], dest[s + 1] = self._mask_dest_row(s)
        self._dense = (mask, dest)
        return self._dense

    # -- forced runs (grammar fast-forward) --------------------------------------
    # A state whose mask admits exactly one token forces it: the masked sample
    # picks it at any temperature, so the engine may emit it without a
    # forward of its own. Runs of such states (JSON punctuation, known key
    # names, enum tails) append in one multi-token forward.

    def forced_token(self, state: int) -> int | None:
        """The one legal token at ``state``, or None when the mask admits
        none or several. Cached per state."""
        if state in self._forced:
            return self._forced[state]
        tok: int | None = None
        if state >= 0:
            idx = np.flatnonzero(self.mask_for_state(state))
            if idx.size == 1:
                tok = int(idx[0])
        self._forced[state] = tok
        return tok

    def forced_run(self, state: int) -> list[int]:
        """The longest run of forced tokens from ``state``, at most
        ``FORCED_RUN_CAP``; a forced EOS ends it (included), since no state
        follows EOS. Empty when the state's mask is not a single token.
        Cached per state."""
        cached = self._forced_runs.get(state)
        if cached is not None:
            return cached
        run: list[int] = []
        st = state
        while len(run) < FORCED_RUN_CAP:
            tok = self.forced_token(st)
            if tok is None:
                break
            run.append(tok)
            if tok == self.eos_id:
                break
            st = self.advance(st, tok)
            if st < 0:  # a forced token never leaves the DFA; defensive
                break
        self._forced_runs[state] = run
        return run

    def forced_run_table(self) -> tuple[np.ndarray, np.ndarray] | None:
        """Dense ([S+1, FORCED_RUN_CAP] int32 tokens, [S+1] int32 run
        lengths) in the numbering of ``dense_tables`` (row 0 the FREE
        sentinel with no run, DFA state s at row s + 1). None under the
        same budget. Built once and cached."""
        if self._forced_table is not None:
            return self._forced_table
        if self.dense_tables() is None:
            return None
        S = self.dfa.num_states
        toks = np.zeros((S + 1, max(1, FORCED_RUN_CAP)), np.int32)
        lens = np.zeros((S + 1,), np.int32)
        for s in range(S):
            run = self.forced_run(s)
            lens[s + 1] = len(run)
            toks[s + 1, : len(run)] = run
        self._forced_table = (toks, lens)
        return self._forced_table


class JsonConstraint:
    """Engine-facing ``mask_fn``: tracks the DFA state incrementally across
    the generated-token list the engine passes each step."""

    def __init__(self, fsm: TokenFSM):
        self.fsm = fsm
        self._state = fsm.dfa.start
        self._consumed = 0

    def __call__(self, tokens: list[int]) -> np.ndarray:
        return self.fsm.mask_for_state(self.dfa_state(tokens))

    def dfa_state(self, tokens: list[int]) -> int:
        """The DFA state after ``tokens`` (EOS skipped), the same
        incremental walk ``__call__`` makes, without building a mask."""
        if len(tokens) < self._consumed:  # a new sequence reusing the object
            self._state, self._consumed = self.fsm.dfa.start, 0
        for tok in tokens[self._consumed:]:
            if tok != self.fsm.eos_id:
                self._state = self.fsm.advance(self._state, tok)
        self._consumed = len(tokens)
        return self._state

    def forced_run(self, tokens: list[int]) -> list[int]:
        """The forced run from the state after ``tokens`` (maybe empty; at
        most ``FORCED_RUN_CAP``; a forced EOS ends it)."""
        st = self.dfa_state(tokens)
        return [] if st < 0 else self.fsm.forced_run(st)


def device_table_fsm(mask_fn) -> TokenFSM | None:
    """The TokenFSM behind an engine ``mask_fn`` when, and only when, its
    dense device tables fit the budget. A plain callable, or a schema whose
    tables exceed the budget, gives None: such rows mask on the host."""
    if not isinstance(mask_fn, JsonConstraint):
        return None
    return mask_fn.fsm if mask_fn.fsm.dense_tables() is not None else None


# Each client schema pins a compiled TokenFSM, so the per-tokenizer cache is
# a bounded LRU, and schemas whose DFA explodes are refused up front (the
# API answers the ValueError with 400).
FSM_CACHE_CAPACITY = 8
MAX_DFA_STATES = 100_000


def json_constraint(
    tokenizer,
    schema: dict[str, Any] | None = None,
    depth: int = 4,
) -> JsonConstraint:
    """A fresh per-request constraint. The TokenFSM is cached per (schema,
    depth) on the tokenizer object itself, in a bounded LRU that dies with
    the tokenizer. The bookkeeping runs under a per-tokenizer lock (HTTP
    handler threads call this); the compile runs outside it. Of two racing
    compiles of one schema the first one cached wins, so that concurrent
    requests of one schema share one FSM, and one device table set."""
    lock = tokenizer.__dict__.setdefault("_fsm_lock", threading.Lock())
    cache = tokenizer.__dict__.setdefault("_fsm_cache", {})
    key = (json.dumps(schema, sort_keys=True), depth)
    with lock:
        fsm = cache.pop(key, None)
        if fsm is not None:
            cache[key] = fsm  # reinserted at the back: most recently used
    if fsm is None:
        dfa = compile_regex(schema_to_regex(schema, depth))
        if dfa.num_states > MAX_DFA_STATES:
            raise ValueError(
                f"json schema compiles to {dfa.num_states} DFA states "
                f"(limit {MAX_DFA_STATES}); simplify the schema or reduce "
                f"nesting depth"
            )
        tb = [tokenizer.token_bytes(t) for t in range(tokenizer.vocab_size)]
        fsm = TokenFSM(dfa, tb, tokenizer.eos_id)
        with lock:
            fsm = cache.setdefault(key, fsm)
            while len(cache) > FSM_CACHE_CAPACITY:
                cache.pop(next(iter(cache)), None)
    return JsonConstraint(fsm)


# The ReAct wire format the agent loop speaks.
TOOLPROMPT_SCHEMA: dict[str, Any] = {
    "type": "object",
    "properties": {
        "question": {"type": "string"},
        "thought": {"type": "string"},
        "action": {
            "type": "object",
            "properties": {
                "name": {"type": "string"},
                "input": {"type": "string"},
            },
        },
        "observation": {"type": "string"},
        "final_answer": {"type": "string"},
    },
}
