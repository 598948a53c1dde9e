"""The port's scheduler against the JAX package's on the CPU: class-fair
admission, the failure accounting of its loop, and restart recovery.

``tiny-test`` f32 with the JAX engine's weights (``params_from_jax``),
greedy. Each case runs the same request sequence through the JAX scheduler
and the port's and compares what the clients see.

- Admission is class-fair: interactive before batch before background,
  arrival order within a class (JAX ``_admit_rank``); FIFO admission fails
  the order check. ``admission_timeout_s`` is a constructor argument.
- A step that raises twice and then works fails no request: the batch
  fails only after 3 consecutive failures no request accounts for. A
  raising stream callback ends its own request only.
- With an ``engine_factory``, an engine whose every block raises (JAX
  ``tests/test_restart.py``'s sabotage) is rebuilt, warmed up and the
  request re-admitted with its tokens so far: the tokens equal an
  uninterrupted greedy run, a stream gets no token twice, the flight ring
  holds ``engine_restart``. Without restarts left the request fails with
  "engine step failed" and keeps its ``generated_prefix``.
"""

import functools
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opsagent_tpu import obs as jobs
from opsagent_tpu.serving.engine import Engine as JaxEngine
from opsagent_tpu.serving.engine import EngineConfig as JaxEngineConfig
from opsagent_tpu.serving.sampler import SamplingParams as JaxSamplingParams
from opsagent_tpu.serving.scheduler import Request as JaxRequest
from opsagent_tpu.serving.scheduler import Scheduler as JaxScheduler
from opsagent_tpu_torch import obs as pobs
from opsagent_tpu_torch.models.config import TINY_TEST
from opsagent_tpu_torch.models.convert import params_from_jax
from opsagent_tpu_torch.models.llama import Llama
from opsagent_tpu_torch.serving.engine import Engine, EngineConfig
from opsagent_tpu_torch.serving.sampler import SamplingParams
from opsagent_tpu_torch.serving.scheduler import Request, Scheduler

KW = dict(page_size=8, num_pages=256, max_pages_per_seq=32, max_batch_size=4)
JAX_CFG = dict(model="tiny-test", dtype=jnp.float32, tp=1, prefill_buckets=(16,), **KW)
PORT_CFG = EngineConfig(model="tiny-test", dtype=torch.float32, device="cpu",
                        decode_block=8, **KW)
PROMPT, MAX_TOKENS = [9, 8, 7, 6], 12


@functools.lru_cache(maxsize=None)
def _model():
    jeng = JaxEngine(JaxEngineConfig(**JAX_CFG))
    model = Llama(TINY_TEST, torch.float32, "cpu", seed=None)
    model.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, jeng.params),
                                          TINY_TEST))
    return model


def _jax_engine():
    return JaxEngine(JaxEngineConfig(**JAX_CFG))


def _port_engine():
    return Engine(PORT_CFG, model=_model())


@functools.lru_cache(maxsize=None)
def _uninterrupted():
    return tuple(_jax_engine().generate([PROMPT], JaxSamplingParams(max_tokens=MAX_TOKENS))[0])


# Each side: (engine factory, scheduler class, request class, sampling
# class, obs package).
SIDES = {
    "jax": (_jax_engine, JaxScheduler, JaxRequest, JaxSamplingParams, jobs),
    "port": (_port_engine, Scheduler, Request, SamplingParams, pobs),
}


def _classed(obs_pkg, cls: str):
    """A span of a trace of SLO class ``cls`` (what the API stamps)."""
    t = obs_pkg.Trace(obs_pkg.new_request_id("sched"))
    t.slo_class = cls
    return t.root


# -- class-fair admission -------------------------------------------------------
ARRIVALS = ["batch", "background", "interactive", "batch", "interactive"]


@pytest.mark.parametrize("side", sorted(SIDES))
def test_admission_is_class_fair(side):
    """Five requests arrive before a tick with three batch slots: the two
    interactive ones admit first, then the first batch one; the second
    batch and the background one wait, in that order."""
    make, sched_cls, req_cls, sp_cls, obs_pkg = SIDES[side]
    eng = make()
    sched = sched_cls(eng)
    eng.cfg.max_batch_size = 3
    reqs = [req_cls([257, i + 1], sp_cls(max_tokens=2), trace=_classed(obs_pkg, c))
            for i, c in enumerate(ARRIVALS)]
    sched._waiting.extend(reqs)          # queued in arrival order, before a tick
    sched._try_admit()
    admitted = sorted((r.seq_id, i) for i, r in enumerate(reqs) if r.seq_id is not None)
    assert [i for _, i in admitted] == [2, 4, 0]
    assert [reqs.index(r) for r in sched._waiting] == [3, 1]


@pytest.mark.parametrize("side", sorted(SIDES))
def test_admission_timeout_is_a_constructor_argument(side):
    make, sched_cls, req_cls, sp_cls, obs_pkg = SIDES[side]
    sched = sched_cls(make(), admission_timeout_s=0.0)
    before = obs_pkg.ENGINE_REQUESTS.value(outcome="timeout")
    req = req_cls([257, 1], sp_cls(max_tokens=2))
    req.enqueued_s -= 1.0
    sched.submit(req)
    sched._drain_queue()
    sched._try_admit()
    assert req.done.is_set() and req.error == "admission timed out (engine saturated)"
    assert obs_pkg.ENGINE_REQUESTS.value(outcome="timeout") == before + 1


# -- failure accounting ----------------------------------------------------------
def _run(side, flaky_blocks=0, on_token=None, **sched_kw):
    """One request through a started scheduler whose first ``flaky_blocks``
    step_block calls raise; (request, scheduler)."""
    make, sched_cls, req_cls, sp_cls, _ = SIDES[side]
    eng = make()
    real, calls = eng.step_block, [0]

    def flaky(*a, **k):
        calls[0] += 1
        if calls[0] <= flaky_blocks:
            raise RuntimeError("transient device error")
        return real(*a, **k)

    eng.step_block = flaky
    sched = sched_cls(eng, **sched_kw)
    sched.start()
    try:
        req = sched.submit(req_cls(PROMPT, sp_cls(max_tokens=MAX_TOKENS), on_token=on_token))
        assert req.done.wait(120)
    finally:
        sched.stop()
    return req, sched


@pytest.mark.parametrize("side", sorted(SIDES))
def test_two_unattributed_failures_fail_nothing(side):
    req, _ = _run(side, flaky_blocks=2)
    assert not req.error, req.error
    assert tuple(req.tokens) == _uninterrupted()


@pytest.mark.parametrize("side", sorted(SIDES))
def test_a_raising_stream_callback_ends_its_own_request(side):
    make, sched_cls, req_cls, sp_cls, _ = SIDES[side]
    seen = []

    def broken(tok):
        seen.append(tok)
        if len(seen) == 3:
            raise ConnectionResetError("client went away")

    sched = sched_cls(make())
    sched.start()
    try:
        bad = sched.submit(req_cls([257, 3, 1, 4], sp_cls(max_tokens=MAX_TOKENS),
                                   on_token=broken))
        good = sched.submit(req_cls(PROMPT, sp_cls(max_tokens=MAX_TOKENS)))
        assert bad.done.wait(120) and good.done.wait(120)
    finally:
        sched.stop()
    assert bad.error and len(seen) == 3
    assert not good.error and tuple(good.tokens) == _uninterrupted()


# -- restart recovery --------------------------------------------------------------
def _sabotage(engine):
    """Every block raises, as on a lost device (tests/test_restart.py)."""
    def boom(*a, **k):
        raise RuntimeError("device runtime lost")
    engine.step_block = boom


def _recovering(side, max_restarts=3, sabotage_again=False, on_token=None):
    make, sched_cls, req_cls, sp_cls, _ = SIDES[side]

    def factory():
        eng = make()
        if sabotage_again:
            _sabotage(eng)
        return eng

    sched = sched_cls(make(), engine_factory=factory, max_restarts=max_restarts)
    sched.start()
    try:
        req = sched.submit(req_cls(PROMPT, sp_cls(max_tokens=MAX_TOKENS), on_token=on_token))
        deadline = time.time() + 60
        while time.time() < deadline:
            sids = list(sched._running)
            if sids and sched.engine.sequences[sids[0]].tokens:
                break
            time.sleep(0.005)
        assert sched._running, "the request never decoded"
        _sabotage(sched.engine)
        assert req.done.wait(180)
    finally:
        sched.stop()
    return req, sched


@pytest.mark.parametrize("side", sorted(SIDES))
def test_restart_recovers_with_the_uninterrupted_tokens(side):
    obs_pkg = SIDES[side][4]
    streamed: list[int] = []
    req, sched = _recovering(side, on_token=streamed.append)
    assert not req.error, req.error
    assert sched._restarts == 1 and sched.engine is not None
    assert tuple(req.tokens) == _uninterrupted()
    assert streamed == req.tokens                  # no token sent twice
    assert req.generated_prefix and req.tokens[:len(req.generated_prefix)] == \
        req.generated_prefix
    reasons = [e.get("reason") for e in obs_pkg.flight.get_recorder().snapshot()
               if e["kind"] == "anomaly"]
    assert "engine_restart" in reasons
    if side == "port":
        assert sched.engine._warm                    # warmed before re-admission


@pytest.mark.parametrize("side", sorted(SIDES))
def test_without_restarts_left_the_request_fails_with_its_prefix(side):
    req, sched = _recovering(side, max_restarts=1, sabotage_again=True)
    assert "engine step failed" in req.error
    assert sched._restarts == 1
    # The first engine's tokens were salvaged before the second one died,
    # and stay in the result ahead of what the second one produced.
    assert req.generated_prefix and req.tokens[:len(req.generated_prefix)] == \
        req.generated_prefix
    assert tuple(req.tokens) == _uninterrupted()[:len(req.tokens)]


@pytest.mark.parametrize("side", sorted(SIDES))
def test_no_factory_fails_after_three_failures(side):
    req, sched = _run(side, flaky_blocks=10**6)
    assert "engine step failed" in req.error
    assert not sched._running
