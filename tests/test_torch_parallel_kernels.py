"""The tensor-parallel kernel wrappers against the JAX package's, on the CPU.

Two gloo ranks each call ``paged_ragged_attention_tp`` /
``paged_decode_attention_tp`` on their own query and kv heads, and
``quant_matmul_tp`` on their own weight columns; the results gathered over
tp equal JAX's ``paged_*_attention_pallas_tp`` (both forms: the DMA kernel
and the grid kernel, in interpret mode) and ``quant_matmul_pallas_tp`` on a
tp = 2 mesh. On the CPU each rank's wrapper runs its kernel's plain
version. Tolerances: f32 at 1e-5, bf16 at 1e-2 (one bf16 ulp below 2),
int8 pages at 2e-5 (JAX scales in score space, the port dequantizes rows),
the quantized matmul at 1e-5 (one f32 contraction in another order). A
rank holding the wrong heads raises.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from opsagent_tpu.models.quant import quantize_weight, quantize_weight4
from opsagent_tpu.ops.attention import (
    QuantizedPages,
    paged_decode_attention_pallas_tp,
    paged_ragged_attention_pallas_tp,
)
from opsagent_tpu.ops.quant_matmul_pallas import quant_matmul_pallas_tp
from opsagent_tpu.parallel.mesh import make_mesh as jmake_mesh

from _torch_spmd_kit import run_ranks

B, S, D, P, MAXP, N = 3, 8, 16, 4, 6, 20
# (name, heads, kv heads, dtype, int8 pages, JAX impl, port backend)
CASES = [
    ("dma_f32", 4, 2, np.float32, False, "pallas-dma", "dma"),
    ("dma_int8", 4, 2, np.float32, True, "pallas-dma", "dma"),
    ("dma_bf16", 4, 2, jnp.bfloat16, False, "pallas-dma", "dma"),
    ("grid_f32_g7", 14, 2, np.float32, False, "pallas", "grid"),
    ("grid_int8_g7", 14, 2, np.float32, True, "pallas", "grid"),
    ("grid_bf16", 4, 2, jnp.bfloat16, False, "pallas", "grid"),
]
TOL = {"f32": 1e-5, "int8": 2e-5, "bf16": 1e-2}


def _case(rng, H, K, dtype, int8):
    start = np.array([5, 0, 9], np.int32)
    q_lens = np.array([8, 0, 3], np.int32)
    table = np.full((B, MAXP), -1, np.int32)
    free = list(rng.permutation(N))
    for b in range(B):
        for i in range(-(-(start[b] + q_lens[b]) // P)):
            table[b, i] = free.pop()
    c = dict(q=rng.standard_normal((B, S, H, D)), qd=rng.standard_normal((B, H, D)),
             table=table, start=start, q_lens=q_lens,
             lengths=np.array([13, 0, 12], np.int32))
    for side in ("k", "v"):
        if int8:
            c[side] = rng.integers(-127, 128, (N, P, K, D)).astype(np.int8)
            c[f"{side}_scale"] = rng.uniform(0.001, 0.02, (N, P, K)).astype(np.float32)
        else:
            c[side] = rng.standard_normal((N, P, K, D))
    for name in ("q", "qd") + (() if int8 else ("k", "v")):
        c[name] = np.asarray(jnp.asarray(c[name], dtype)).astype(np.float32) \
            if dtype == jnp.bfloat16 else c[name].astype(np.float32)
    return c


def _jax_pages(c, side, dtype, int8):
    if int8:
        return QuantizedPages(jnp.asarray(c[side]), jnp.asarray(c[f"{side}_scale"]))
    return jnp.asarray(c[side], dtype)


@pytest.fixture(scope="module")
def attention(tmp_path_factory):
    rng = np.random.default_rng(0)
    cases = {name: _case(rng, H, K, dt, i8) for name, H, K, dt, i8, _, _ in CASES}
    inputs = {}
    for name, H, K, dt, i8, _, _ in CASES:
        for k, v in cases[name].items():
            # bf16 cases travel as f32 arrays of bf16 values; the ranks cast.
            inputs[f"{name}_{k}"] = v
    specs = [dict(name=n, heads=H, kv_heads=K, backend=be, bf16=dt == jnp.bfloat16)
             for n, H, K, dt, _, _, be in CASES]
    outs = run_ranks("attention", 2, tmp_path_factory.mktemp("attn"), inputs,
                     {"cases": specs})
    return cases, outs


@pytest.mark.parametrize("name,H,K,dtype,int8,impl,backend", CASES)
def test_attention_tp_matches_jax_pallas_tp(attention, name, H, K, dtype, int8, impl, backend):
    cases, outs = attention
    c = cases[name]
    mesh = jmake_mesh(tp=2, dp=1, sp=1, devices=jax.devices()[:2])
    kp, vp = (_jax_pages(c, s, dtype, int8) for s in ("k", "v"))
    q = jnp.asarray(c["q"], dtype)
    want = np.asarray(paged_ragged_attention_pallas_tp(
        q, kp, vp, c["table"], c["start"], c["q_lens"], mesh, interpret=True, impl=impl,
    ).astype(jnp.float32))
    qd = jnp.asarray(c["qd"], dtype)
    want_d = np.asarray(paged_decode_attention_pallas_tp(
        qd, kp, vp, c["table"], c["lengths"], mesh, interpret=True, impl=impl,
    ).astype(jnp.float32))
    tol = TOL["int8" if int8 else ("bf16" if dtype == jnp.bfloat16 else "f32")]
    ok = np.arange(S)[None, :] < c["q_lens"][:, None]
    active = c["lengths"] > 0
    for out in outs:  # every rank holds the gathered result
        got = out[f"{name}_ragged"].astype(np.float32)
        np.testing.assert_allclose(got[ok], want[ok], rtol=tol, atol=tol)
        assert (got[~ok] == 0).all()
        got = out[f"{name}_decode"].astype(np.float32)
        np.testing.assert_allclose(got[active], want_d[active], rtol=tol, atol=tol)
        assert out[f"{name}_bad_shard_raised"] == 1


@pytest.fixture(scope="module")
def quant(tmp_path_factory):
    rng = np.random.default_rng(4)
    dense = jnp.asarray(rng.standard_normal((256, 256)), jnp.float32)
    x = rng.standard_normal((8, 256)).astype(np.float32)
    ws = {"int8": quantize_weight(dense), "int4": quantize_weight4(dense, group=128)}
    inputs = {"x": x}
    for mode, w in ws.items():
        inputs[f"{mode}_q"], inputs[f"{mode}_scale"] = np.asarray(w.q), np.asarray(w.scale)
    outs = run_ranks("quant", 2, tmp_path_factory.mktemp("qmm"), inputs,
                     {"modes": list(ws)})
    return x, ws, outs


@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_quant_matmul_tp_matches_jax_pallas_tp(quant, mode):
    x, ws, outs = quant
    mesh = jmake_mesh(tp=2, dp=1, sp=1, devices=jax.devices()[:2])
    want = np.asarray(quant_matmul_pallas_tp(jnp.asarray(x), ws[mode], mesh, interpret=True))
    for out in outs:
        np.testing.assert_allclose(out[mode], want, rtol=1e-5, atol=1e-5)
