"""The one traffic generator. A mix is a data file of parameters
(``traffic/<mix>.json``) that this module reads; the program sees only the
token ids it makes.

Closed loop: ``clients`` clients each send a request, wait for its last
token, think, and send the next. A client's r-th request belongs to round
r. Every length and think time of a round is drawn stratified: round r
holds a permutation of ``clients`` quantiles of the stated distribution.
These schedules (and the prefixes' lengths and choices) are the mix's
own, the same for every seed; the seed deals the schedules to the
clients in another order and draws every token id. So runs of different
seeds do the same work. Token ids are drawn uniformly from the
configuration's ``token_range`` (below its special ids).

Parameters of a mix:

- ``clients``: closed-loop clients.
- ``prefixes``: {"count", "tokens": dist}: shared prefixes (a system
  prompt, documents). A request starts from one, chosen so that each is
  used by the same number of clients in a round. Absent: none.
- ``prefix_setup``: "split_lane" to prefill the prefixes (and the
  staggered sessions' histories) into the prefix cache in set-up through
  the engine's split prefill lane.
- ``carry``, ``max_turns`` and ``max_context``: sessions. A request is
  the client's previous prompt, its reply and ``new_tokens`` more; after
  ``max_turns`` turns, or where the next prompt would pass
  ``max_context`` tokens, the session ends and a new one starts from a
  prefix with ``first_tokens`` (its question; absent: ``new_tokens``).
- ``stagger``: sessions meet the window at every stage of their life, as
  a steady stream of sessions has them: schedule column k's session has
  made k mod ``max_turns`` turns before round 0, a history of the mix's
  own lengths (ids from the seed) that set-up prefills through the split
  lane (``warm``), so that round 0 is its next turn.
- ``new_tokens``, ``reply_tokens``, ``think_s``, ``first_tokens``:
  distributions, each {"dist": "uniform" | "loguniform" | "fixed", "lo",
  "hi"} ("fixed": "lo").
- ``setup_reply_tokens``: a cap on the replies of round 0, which runs in
  set-up (a session's next turn; else a warm-up request); absent: no cap.
- ``source``, ``assumed``: where the numbers come from (not read).

Round 0 runs in set-up; the window sends rounds 1 and on.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

DISTS = ("uniform", "loguniform", "fixed")


@dataclass
class Request:
    client: int
    round: int
    prompt: list[int]
    max_tokens: int
    think_s: float
    turn: int = 1            # the session's turn this request makes


def quantiles(dist: dict, n: int) -> np.ndarray:
    """The n stratified values (i + 0.5) / n of ``dist``."""
    kind, lo = dist["dist"], float(dist["lo"])
    if kind not in DISTS:
        raise ValueError(f"unknown distribution {kind!r}")
    if kind == "fixed":
        return np.full(n, lo)
    hi = float(dist["hi"])
    u = (np.arange(n) + 0.5) / n
    if kind == "uniform":
        return lo + u * (hi - lo)
    return np.exp(math.log(lo) + u * (math.log(hi) - math.log(lo)))


class Traffic:
    def __init__(self, mix: dict, seed: int, token_range: tuple[int, int]):
        self.mix, self.seed = mix, int(seed) % (1 << 64)
        self.lo, self.hi = int(token_range[0]), int(token_range[1])
        self.clients = int(mix["clients"])
        self._rounds: dict[int, dict[str, np.ndarray]] = {}
        # Client c follows the seed-independent schedule column _deal[c].
        self._deal = self._rng("deal").permutation(self.clients)
        pre = mix.get("prefixes")
        self.prefixes: list[list[int]] = []
        if pre:
            lengths = self._rng("prefix_len", fixed=True).permutation(
                np.rint(quantiles(pre["tokens"], int(pre["count"]))).astype(int))
            self.prefixes = [self._ids(("prefix", i), int(n)) for i, n in enumerate(lengths)]
        # client -> (context: prompt and reply so far, turns made)
        self._session: dict[int, tuple[list[int], int]] = {}
        self.histories: dict[int, tuple[list[int], int]] = {}
        if mix.get("stagger"):
            for c in range(self.clients):
                history = self._history(c, int(self._deal[c]) % int(mix["max_turns"]))
                if history[1]:
                    self.histories[c] = history

    def _rng(self, *tags, fixed: bool = False) -> np.random.Generator:
        """A generator of the seed's (or, ``fixed``, of the mix's own)."""
        seed = 0 if fixed else self.seed
        words = [seed & 0xFFFFFFFF, seed >> 32, int(fixed)]
        for t in tags:
            words += [t] if isinstance(t, int) else list(str(t).encode())
        return np.random.default_rng(np.random.SeedSequence(words))

    def _ids(self, tag, n: int) -> list[int]:
        return self._rng("ids", *(tag if isinstance(tag, tuple) else (tag,))).integers(
            self.lo, self.hi, size=n).tolist()

    def _draw(self, *tags) -> dict[str, np.ndarray]:
        """One schedule of the mix's own: each key's stratified values
        permuted by ``tags``, column ``_deal[c]`` for client c."""
        n, mix = self.clients, self.mix
        out = {}
        for key in ("new_tokens", "reply_tokens", "think_s", "first_tokens"):
            if key not in mix:
                continue
            vals = quantiles(mix[key], n)
            if key != "think_s":
                vals = np.maximum(1, np.rint(vals)).astype(int)
            out[key] = self._rng(key, *tags, fixed=True).permutation(vals)[self._deal]
        if self.prefixes:
            out["prefix"] = (self._rng("prefix", *tags, fixed=True).permutation(n)
                             % len(self.prefixes))[self._deal]
        return out

    def _round(self, r: int) -> dict[str, np.ndarray]:
        if r not in self._rounds:
            self._rounds[r] = self._draw(r)
        return self._rounds[r]

    def _first(self, client: int, d: dict, tag) -> list[int]:
        """A new session's prompt: a prefix and the session's question."""
        base = self.prefixes[int(d["prefix"][client])] if self.prefixes else []
        n = d["first_tokens" if "first_tokens" in d else "new_tokens"][client]
        return base + self._ids(("new", client) + tag, int(n))

    def _fits(self, context: list[int], turns: int, more: int) -> bool:
        mix = self.mix
        return (turns < int(mix.get("max_turns", 1 << 30))
                and len(context) + more <= int(mix.get("max_context", 1 << 30)))

    def _history(self, client: int, turns: int) -> tuple[list[int], int]:
        """The context of a session that has made up to ``turns`` turns
        before round 0 (fewer where ``max_context`` ends it), and their
        number; its replies are ids from the seed."""
        d = self._draw("history", 0)
        context, made = self._first(client, d, ("history", 0)), 0
        while made < turns:
            d = self._draw("history", made)
            if made:
                new = int(d["new_tokens"][client])
                if not self._fits(context, made, new):
                    break
                context = context + self._ids(("history_new", client, made), new)
            context = context + self._ids(("history_reply", client, made),
                                          int(d["reply_tokens"][client]))
            made += 1
        return context, made

    def warm(self) -> list[list[int]]:
        """What set-up prefills through the split lane: the prefixes and
        the staggered sessions' histories."""
        return self.prefixes + [self.histories[c][0] for c in sorted(self.histories)]

    def request(self, client: int, r: int) -> Request:
        """Client ``client``'s request of round ``r``. With ``carry``, the
        client's previous request must have been given its reply
        (``reply``) first."""
        d = self._round(r)
        max_tokens = int(d["reply_tokens"][client])
        cap = self.mix.get("setup_reply_tokens")
        if r == 0 and cap:
            max_tokens = min(max_tokens, int(cap))
        think = float(d["think_s"][client])
        if self.mix.get("carry"):
            context, made = self._session.get(client) or self.histories.get(client) or ([], 0)
            new = int(d["new_tokens"][client])
            if made and self._fits(context, made, new):
                prompt = context + self._ids(("new", client, r), new)
                return Request(client, r, prompt, max_tokens, think, made + 1)
        return Request(client, r, self._first(client, d, (r,)), max_tokens, think)

    def think_s(self, client: int, r: int) -> float:
        """The client's think time before its request of round ``r``."""
        return float(self._round(r)["think_s"][client])

    def reply(self, req: Request, tokens: list[int]) -> None:
        """A session carries its request's prompt and reply on."""
        if self.mix.get("carry"):
            self._session[req.client] = (req.prompt + list(tokens), req.turn)
