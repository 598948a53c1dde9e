"""The sample that ``correct`` judges: a session's earlier turns lie inside
its latest turn's tokens and join that one reference pass, which reads
each served token at its own position exactly as a pass of its own
would; requests that share no such prefix stay one a pass."""

import torch

from portbench import judge
from portbench.reference import qwen2
from portbench.tests import tiny
from portbench.weights import Maker


def session(start: int, turns: int) -> list[tuple[list[int], list[int]]]:
    """(prompt, served) of each turn of one session over ids from
    ``start``: a turn carries the previous prompt and reply on."""
    out, prompt, k = [], list(range(start, start + 5)), start + 5
    for _ in range(turns):
        served = list(range(k, k + 3))
        out.append((prompt, served))
        prompt = prompt + served + [k + 3, k + 4]
        k += 5
    return out


def test_a_session_is_judged_in_one_pass_of_its_latest_turn():
    done = session(0, 4) + session(100, 2) + [([200, 201], [202, 203])]
    groups = judge.sample(done, 2**40 + 7, tokens=10**6)
    assert sorted(sorted(g) for g in groups) == [[0, 1, 2, 3], [4, 5], [6]]
    assert {g[0] for g in groups} == {3, 5, 6}          # each session's latest turn


def test_a_group_reads_each_turn_as_its_own_pass_would():
    conf = tiny.qwen2()
    maker = Maker(2**33 + 1, "cpu", torch.float32)
    weights = lambda sp: maker.make(sp).float()        # noqa: E731
    done = session(0, 3)
    one, _ = judge.gaps(qwen2, conf, weights, done, [[2, 0, 1]], torch.device("cpu"))
    alone = [judge.gaps(qwen2, conf, weights, done, [[i]], torch.device("cpu"))[0]
             for i in range(3)]
    assert abs(one["mean"] - sum(a["mean"] for a in alone) / 3) < 1e-5
    assert abs(one["max"] - max(a["max"] for a in alone)) < 1e-5
    assert one["mean"] > 0      # arbitrary tokens lie below the reference's best
