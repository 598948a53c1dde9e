"""Shared pieces of the fleet's parity tests (``tests/test_torch_fleet*.py``,
``test_torch_pagestore.py``, ``test_torch_opscli.py``): each package's fleet
modules under one name, in-process two-replica fleets over tiny-test f32 with
the same weights in both packages (the port's carried across by
``models/convert.params_from_jax``), and the resets of the port's state.

The JAX engines run their default mixed batching (the port admits through
mixed ticks only); greedy tokens are equal across the packages at f32.
"""

import functools
import time
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_agent_kit import reset_port

JBASE = dict(model="tiny-test", dtype=jnp.float32, tp=1, page_size=4, num_pages=256,
             max_pages_per_seq=64, max_batch_size=4, prefill_buckets=(16, 32, 64),
             decode_block=4, seed=0, offload=True)
PBASE = dict(page_size=4, num_pages=256, max_pages_per_seq=64, max_batch_size=4,
             decode_block=4, mixed_buckets=(4, 8, 16), max_step_tokens=32, offload=True)
PKGS = ("jax", "torch")


def package(name: str) -> types.SimpleNamespace:
    """The fleet modules of ``name`` ("jax": opsagent_tpu, "torch": the port)
    and how it builds a serving stack."""
    if name == "jax":
        from opsagent_tpu import obs
        from opsagent_tpu.serving import api, faults, scheduler, tokenizer
        from opsagent_tpu.serving.fleet import client, pagestore, registry, router, transfer
        from opsagent_tpu.serving.offload import pool
        from opsagent_tpu.serving.sampler import SamplingParams
    else:
        from opsagent_tpu_torch import obs
        from opsagent_tpu_torch.serving import api, faults, scheduler, tokenizer
        from opsagent_tpu_torch.serving.fleet import (
            client, pagestore, registry, router, transfer)
        from opsagent_tpu_torch.serving.offload import pool
        from opsagent_tpu_torch.serving.sampler import SamplingParams
    return types.SimpleNamespace(
        name=name, obs=obs, api=api, faults=faults, scheduler=scheduler, client=client,
        pagestore=pagestore, registry=registry, router=router, transfer=transfer,
        pool=pool, SamplingParams=SamplingParams, tokenizer=tokenizer,
        engine=functools.partial(jax_engine if name == "jax" else port_engine),
    )


def jax_engine(**over):
    from opsagent_tpu.serving.engine import Engine, EngineConfig

    return Engine(EngineConfig(**{**JBASE, **over}))


@functools.lru_cache(maxsize=None)
def port_model():
    """tiny-test f32 with the JAX engine's weights (seed 0)."""
    from opsagent_tpu_torch.models.config import TINY_TEST
    from opsagent_tpu_torch.models.convert import params_from_jax
    from opsagent_tpu_torch.models.llama import Llama

    params = jax.tree_util.tree_map(np.asarray, jax_engine(offload=False).params)
    model = Llama(TINY_TEST, torch.float32, "cpu", seed=None)
    model.load_state_dict(params_from_jax(params, TINY_TEST))
    return model


def port_engine(**over):
    from opsagent_tpu_torch.serving.engine import Engine, EngineConfig

    model = port_model()
    return Engine(EngineConfig(model="tiny-test", dtype=torch.float32, device="cpu",
                               **{**PBASE, **over}), model=model)


def stack(pkg, **over):
    return pkg.api.ServingStack(pkg.engine(**over))


def fleet(pkg, n=2, engine_over=None, **router_kw):
    """(router, stacks): ``n`` in-process replicas r0.. behind a FleetRouter."""
    router = pkg.router.FleetRouter(**router_kw)
    stacks = []
    for i in range(n):
        s = stack(pkg, **(engine_over or {}))
        stacks.append(s)
        router.add_local(s, f"r{i}")
    return router, stacks


def close(stacks):
    for s in stacks:
        s.close()


def slow_decode(stacks, seconds=0.01):
    """Slow each engine's decode blocks (a sleep before each), so that a
    drain or a fault lands while requests are still decoding."""
    for s in stacks:
        eng = s.engine
        inner = eng.step_block

        def step_block(*a, _inner=inner, **kw):
            time.sleep(seconds)
            return _inner(*a, **kw)

        eng.step_block = step_block


TIMING = {"ts", "wall", "id", "duration_ms", "ms", "request_id", "session", "age_s",
          "heartbeat_age_s", "wall_corrected", "t0_wall"}


def events(pkg, kinds) -> list[dict]:
    """The flight ring's events of ``kinds`` without clocks and ids."""
    return [{k: v for k, v in e.items() if k not in TIMING}
            for e in pkg.obs.flight.get_recorder().snapshot() if e.get("kind") in kinds]


def text(resp) -> str:
    return resp["choices"][0]["message"]["content"] or ""


@pytest.fixture(autouse=True)
def port_state(tmp_path, monkeypatch):
    """Fresh port state around each test (tests/conftest.py resets only the
    JAX package's), anomaly dumps in the test's directory."""
    monkeypatch.setenv("OPSAGENT_FLIGHT_DIR", str(tmp_path / "flight"))
    reset_port()
    yield
    reset_port()


# -- HTTP --------------------------------------------------------------------------
def serve_aiohttp(app):
    """Run an aiohttp app (the JAX package's) on a localhost port in a
    thread of its own; (base_url, stop)."""
    import asyncio
    import threading

    from aiohttp import web

    loop = asyncio.new_event_loop()
    box = {}

    async def start():
        runner = web.AppRunner(app)
        await runner.setup()
        site = web.TCPSite(runner, "127.0.0.1", 0)
        await site.start()
        box["runner"], box["port"] = runner, runner.addresses[0][1]

    t = threading.Thread(target=loop.run_forever, daemon=True)
    t.start()
    asyncio.run_coroutine_threadsafe(start(), loop).result(timeout=30)

    def stop():
        asyncio.run_coroutine_threadsafe(box["runner"].cleanup(), loop).result(timeout=30)
        loop.call_soon_threadsafe(loop.stop)
        t.join(timeout=10)

    return f"http://127.0.0.1:{box['port']}", stop


def serve_stdlib(server):
    """Run a port ``ThreadingHTTPServer`` in a thread; (base_url, stop)."""
    import threading

    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()

    def stop():
        server.shutdown()
        server.server_close()
        t.join(timeout=10)

    return f"http://127.0.0.1:{server.server_address[1]}", stop


def serve_router(pkg, router):
    if pkg.name == "jax":
        return serve_aiohttp(pkg.router.build_router_app(router))
    return serve_stdlib(pkg.router.build_router_app(router, "127.0.0.1", 0))


def serve_engine(pkg, s, membership=None):
    if pkg.name == "jax":
        return serve_aiohttp(pkg.api.build_engine_app(s, membership=membership))
    return serve_stdlib(pkg.api.make_server(s, "127.0.0.1", 0, membership=membership))


def call(url, path, body=None, raw=None, timeout=60):
    """(status, headers, parsed JSON body or text) of one request; a body
    makes it a POST (``raw`` bytes are sent as they are)."""
    import json
    import urllib.error
    import urllib.request

    data = raw if raw is not None else (None if body is None else json.dumps(body).encode())
    req = urllib.request.Request(url + path, data=data,
                                 method="POST" if data is not None else "GET",
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            status, headers, payload = r.status, dict(r.headers), r.read().decode()
    except urllib.error.HTTPError as e:
        status, headers, payload = e.code, dict(e.headers), e.read().decode()
    try:
        return status, headers, json.loads(payload)
    except ValueError:
        return status, headers, payload


def sse_chunks(payload: str) -> list:
    """The JSON chunks of an SSE body, ``[DONE]`` as the string."""
    import json

    out = []
    for line in payload.splitlines():
        if line.startswith("data: "):
            data = line[len("data: "):]
            out.append(data if data == "[DONE]" else json.loads(data))
    return out


def shape(v):
    """A JSON value's key structure: dict keys (recursively) and the shape
    of a list's first element; scalars are ``""``."""
    if isinstance(v, dict):
        return {k: shape(x) for k, x in v.items()}
    if isinstance(v, list):
        return [shape(v[0])] if v else []
    return ""
