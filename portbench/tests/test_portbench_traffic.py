"""The traffic generator over each committed mix: ids from the seed alone,
lengths inside the stated ranges, every seed the same set of sizes, and
sessions whose turns extend their previous prompt and reply exactly."""

import json

import pytest

from portbench.generator import Traffic, quantiles
from portbench.spec import PKG

MIXES = sorted(p.stem for p in (PKG / "traffic").glob("*.json"))
RANGE = (0, 151643)


def mix(name: str) -> dict:
    return json.loads((PKG / "traffic" / f"{name}.json").read_text())


def drive(m: dict, seed: int, rounds: int = 4) -> list:
    """Every client's requests of rounds 0..rounds-1, each given a reply of
    its own max_tokens ids."""
    t = Traffic(m, seed, RANGE)
    out = []
    for r in range(rounds):
        for c in range(t.clients):
            rq = t.request(c, r)
            t.reply(rq, list(range(rq.max_tokens)))
            out.append(rq)
    return out


@pytest.mark.parametrize("name", MIXES)
def test_one_seed_gives_the_same_ids_and_another_different_ones(name):
    seed = 2**31 + 12345
    a, b, c = drive(mix(name), seed), drive(mix(name), seed), drive(mix(name), seed + 1)
    assert [r.prompt for r in a] == [r.prompt for r in b]
    assert [r.prompt for r in a] != [r.prompt for r in c]
    assert all(RANGE[0] <= i < RANGE[1] for r in a for i in r.prompt)


@pytest.mark.parametrize("name", MIXES)
def test_lengths_stay_in_their_ranges(name):
    m = mix(name)
    t = Traffic(m, 77, RANGE)
    for key in ("reply_tokens", "new_tokens", "first_tokens"):
        if key not in m:
            continue
        d = m[key]
        for r in range(1, 4):
            vals = t._round(r)[key]
            assert min(vals) >= round(d["lo"]) and max(vals) <= round(d.get("hi", d["lo"]))
    for p in t.prefixes:
        assert m["prefixes"]["tokens"]["lo"] <= len(p) <= m["prefixes"]["tokens"].get("hi", len(p))
    for rq in drive(m, 77):
        if m.get("carry"):
            assert len(rq.prompt) <= m["max_context"] and rq.turn <= m["max_turns"]
        if rq.round == 0 and m.get("setup_reply_tokens"):
            assert rq.max_tokens <= m["setup_reply_tokens"]


@pytest.mark.parametrize("name", MIXES)
def test_every_seed_offers_the_same_sizes_in_another_order(name):
    m = mix(name)
    a, b = Traffic(m, 1, RANGE), Traffic(m, 2, RANGE)
    for r in range(1, 5):
        for key in ("reply_tokens", "new_tokens", "think_s", "first_tokens"):
            if key in m:
                assert sorted(a._round(r)[key]) == sorted(b._round(r)[key])
        assert list(a._round(r)["reply_tokens"]) != list(b._round(r)["reply_tokens"])
    assert sorted(map(len, a.prefixes)) == sorted(map(len, b.prefixes))
    assert sorted((len(h), n) for h, n in a.histories.values()) == \
        sorted((len(h), n) for h, n in b.histories.values())


def test_agent_turns_extend_their_previous_prompt_and_reply_exactly():
    m = mix("agent_sessions")
    t = Traffic(m, 2**33 + 5, RANGE)
    system = t.prefixes[0]
    prev = {c: h for c, (h, _) in t.histories.items()}
    assert {n for _, n in t.histories.values()} == set(range(1, m["max_turns"]))
    warm = t.warm()
    assert warm[0] == system and all(h[: len(system)] == system for h in warm[1:])
    fresh = extended = 0
    for r in range(24):
        for c in range(t.clients):
            rq = t.request(c, r)
            if rq.turn > 1:
                extended += 1
                assert rq.prompt[: len(prev[c])] == prev[c] and len(rq.prompt) > len(prev[c])
            else:
                fresh += 1
                assert rq.prompt[: len(system)] == system   # a new session
                assert len(rq.prompt) - len(system) <= m["first_tokens"]["hi"]
            assert rq.turn <= m["max_turns"] and len(rq.prompt) <= m["max_context"]
            reply = [7] * rq.max_tokens
            t.reply(rq, reply)
            prev[c] = rq.prompt + reply
    assert extended > fresh > t.clients


def test_stratified_quantiles():
    assert list(quantiles({"dist": "uniform", "lo": 0, "hi": 4}, 4)) == [0.5, 1.5, 2.5, 3.5]
    q = quantiles({"dist": "loguniform", "lo": 64, "hi": 768}, 32)
    assert 64 < q.min() < q.max() < 768
    assert list(quantiles({"dist": "fixed", "lo": 3}, 2)) == [3, 3]


@pytest.mark.parametrize("name", MIXES)
def test_seeds_deal_the_same_client_schedules(name):
    m = mix(name)

    def schedules(seed):
        t = Traffic(m, seed, RANGE)
        keys = [k for k in ("new_tokens", "reply_tokens", "think_s", "first_tokens", "prefix")
                if k in t._round(1)]
        return sorted(tuple(tuple(float(t._round(r)[k][c]) for k in keys) for r in range(1, 6))
                      for c in range(t.clients))

    assert schedules(11) == schedules(2**40 + 3)


def test_a_mix_without_sessions_sends_fresh_prompts():
    """A mix with no sessions: a request is its round's new tokens alone,
    and set-up warms nothing."""
    t = Traffic(mix("unshared_prompts"), 5, RANGE)
    rq = t.request(3, 2)
    d = t._round(2)
    assert rq.prompt == t._ids(("new", 3, 2), int(d["new_tokens"][3]))
    assert rq.max_tokens == int(d["reply_tokens"][3]) and rq.turn == 1
    assert t.warm() == [] and not t.histories
