"""Ragged ring attention and the collectives against the JAX package, on
the CPU.

``make_ring_attention`` over sp = 2 and sp = 4 gloo ranks equals JAX's
``make_ring_attention`` on an sp mesh for the cases of
``tests/test_ring_attention.py``: full causal rows and ragged right-padded
rows, GQA groups of 2, in f32 at 1e-5 (the online softmax sums blocks in
ring order, JAX's too). Every rank returns the whole output. The forward
collectives give each rank its axis line's sum, gather, broadcast and
permutation.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from opsagent_tpu.ops.attention import causal_prefill_attention
from opsagent_tpu.parallel.mesh import make_mesh as jmake_mesh
from opsagent_tpu.parallel.ring import make_ring_attention as jmake_ring

from _torch_spmd_kit import run_ranks

TOL = 1e-5


def _cases(rng, S):
    B, H, K, D = 2, 4, 2, 16
    qkv = {n: rng.standard_normal((B, S, h, D)).astype(np.float32)
           for n, h in (("q", H), ("k", K), ("v", K))}
    full = {f"full_{n}": a for n, a in qkv.items()}
    ragged = {f"ragged_{n}": rng.standard_normal(a.shape).astype(np.float32)
              for n, a in qkv.items()}
    ragged["ragged_lengths"] = np.array([S - 3, S // 2 + 1], np.int32)
    return {**full, **ragged}


@pytest.mark.parametrize("sp", [2, 4])
def test_ring_attention_matches_jax(tmp_path, sp):
    S = 8 * sp
    inputs = _cases(np.random.default_rng(sp), S)
    outs = run_ranks("ring", sp, tmp_path, inputs,
                     {"cases": ["full", "ragged"], "mesh": {"sp": sp}})
    mesh = jmake_mesh(tp=1, dp=1, sp=sp, devices=jax.devices()[:sp])
    ring = jmake_ring(mesh)
    for case in ("full", "ragged"):
        q, k, v = (jnp.asarray(inputs[f"{case}_{n}"]) for n in "qkv")
        lengths = inputs.get(f"{case}_lengths")
        want = np.asarray(ring(q, k, v, lengths))
        if lengths is None:
            np.testing.assert_allclose(
                want, np.asarray(causal_prefill_attention(q, k, v)), rtol=1e-4, atol=1e-4)
            ok = np.ones(want.shape[:2], bool)
        else:
            ok = np.arange(S)[None, :] < lengths[:, None]
        for out in outs:
            np.testing.assert_allclose(out[case][ok], want[ok], rtol=TOL, atol=TOL)


def test_collectives_over_each_axis(tmp_path):
    """A (sp = 2, tp = 2) mesh: rank r = 2·sp_index + tp_index."""
    outs = run_ranks("collectives", 4, tmp_path, {}, {"mesh": {"sp": 2, "tp": 2}})
    for r, out in enumerate(outs):
        si, ti = divmod(r, 2)
        for axis, line in (("sp", [ti, 2 + ti]), ("tp", [2 * si, 2 * si + 1])):
            me = line.index(r)
            np.testing.assert_array_equal(out[f"{axis}_sum"], np.full((2, 3), sum(line)))
            np.testing.assert_array_equal(
                out[f"{axis}_gather"], np.array(line, np.float32)[:, None].repeat(3, 1))
            np.testing.assert_array_equal(out[f"{axis}_bcast"], np.full((2, 3), line[1]))
            np.testing.assert_array_equal(out[f"{axis}_ring"], np.full((2, 3), line[me - 1]))
            np.testing.assert_array_equal(out[f"{axis}_partial"],
                                          np.full((2, 3), line[0] if me == 1 else 0))
            assert out[f"{axis}_input_unchanged"]
        assert out["staged"] == 0
