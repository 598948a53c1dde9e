"""The port's placement against the JAX package's, on the CPU.

The spec tables (``param_specs``, ``cache_specs``, ``quantize_specs``)
equal JAX's leaf by leaf for the dense, MoE, MLA and Qwen families;
``shard_params`` gives each rank exactly the shard JAX's ``shard_params``
puts on that device of a tp = 2, dp = 2, sp = 2 mesh; a seeded sharded
model is the slices of the one-rank model; what the mesh refuses raises,
and the training path builds a rank's shard at a mesh. No process group is needed: a rank's view of a mesh
(``Mesh.for_rank``) is enough to slice.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opsagent_tpu.models import config as jconfig
from opsagent_tpu.models import llama as jllama
from opsagent_tpu.models.quant import quantize_specs as jquantize_specs
from opsagent_tpu.parallel.mesh import make_mesh as jmake_mesh
from opsagent_tpu.parallel.mesh import shard_params as jshard_params
from opsagent_tpu_torch.models import config as tconfig
from opsagent_tpu_torch.models.llama import (
    Llama,
    cache_specs,
    local_state,
    param_specs,
    state_specs,
)
from opsagent_tpu_torch.models.quant import quantize_specs
from opsagent_tpu_torch.parallel.mesh import (
    AXES,
    AXIS_ORDER,
    Mesh,
    make_mesh,
    shard_params,
    shard_tensor,
)

QWEN3 = dict(qk_norm=True, attn_bias=False, tie_embeddings=True)
FAMILIES = [
    ("tiny-test", {}), ("tiny-moe", {}), ("tiny-mla", {}), ("bench-8b", {}),
    ("qwen2.5-7b-instruct", {}), ("qwen2.5-7b-instruct", QWEN3), ("deepseek-v3", {}),
    ("deepseek-v2-lite", {}),
]


def _configs(name, change):
    return (dataclasses.replace(jconfig.get_config_preset(name), **change),
            dataclasses.replace(tconfig.get_config_preset(name), **change))


def _flat_jax(tree, path=""):
    """{path: spec tuple} of a JAX spec tree; a QuantizedLinear /
    QuantizedPages node's parts under ``.q`` and ``.scale``."""
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flat_jax(v, f"{path}/{k}"))
    elif hasattr(tree, "q") and hasattr(tree, "scale"):
        out[f"{path}.q"], out[f"{path}.scale"] = tuple(tree.q), tuple(tree.scale)
    else:
        out[path] = tuple(tree)
    return out


def _flat_port(tree, path=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict) and set(v) == {"q", "scale"}:
            out[f"{path}/{k}.q"], out[f"{path}/{k}.scale"] = v["q"], v["scale"]
        elif isinstance(v, dict):
            out.update(_flat_port(v, f"{path}/{k}"))
        else:
            out[f"{path}/{k}"] = v
    return out


@pytest.mark.parametrize("name,change", FAMILIES)
def test_param_and_quantize_specs_equal_jax(name, change):
    jcfg, tcfg = _configs(name, change)
    want = jllama.param_specs(jcfg)
    got = param_specs(tcfg)
    assert _flat_port(got) == _flat_jax(want)
    for mode in ("int8", "int4"):
        assert _flat_port(quantize_specs(got, mode)) == _flat_jax(jquantize_specs(want, mode))


@pytest.mark.parametrize("name,change", FAMILIES)
@pytest.mark.parametrize("kv_quantize", ["", "int8"])
def test_cache_specs_equal_jax(name, change, kv_quantize):
    jcfg, tcfg = _configs(name, change)
    assert (_flat_port(cache_specs(tcfg, kv_quantize))
            == _flat_jax(jllama.cache_specs(jcfg, kv_quantize)))


def test_state_specs_cover_every_state_entry():
    """Every entry of a model's state dict has a spec, of its rank."""
    for name in ("tiny-test", "tiny-moe", "tiny-mla"):
        cfg = tconfig.get_config_preset(name)
        for q in ("", "int8", "int4"):
            specs = state_specs(cfg, q)
            state = Llama(cfg, torch.float32, "cpu", seed=None, quantize=q).state_dict()
            assert set(specs) == set(state), (name, q)
            for k, t in state.items():
                assert len(specs[k]) == t.ndim, (name, q, k)


def test_shard_params_equals_jax_addressable_shards():
    """tiny-test's JAX tree on a tp = 2, dp = 2, sp = 2 mesh: rank i's
    slices equal the shards JAX places on device i."""
    jcfg = jconfig.get_config_preset("tiny-test")
    tcfg = tconfig.get_config_preset("tiny-test")
    params = jllama.init_params(jcfg, jax.random.PRNGKey(1), dtype=jnp.float32)
    jmesh = jmake_mesh(tp=2, dp=2, sp=2)
    placed = jshard_params(params, jllama.param_specs(jcfg), jmesh)
    tree = jax.tree_util.tree_map(lambda a: torch.from_numpy(np.array(a)), params)
    specs = param_specs(tcfg)
    devices = list(jmesh.devices.flat)
    jflat = jax.tree_util.tree_leaves_with_path(placed)
    for rank, dev in enumerate(devices):
        mine = shard_params(tree, specs, Mesh.for_rank({"tp": 2, "dp": 2, "sp": 2}, rank))
        tflat = dict(jax.tree_util.tree_leaves_with_path(mine))
        for path, arr in jflat:
            shard = next(s for s in arr.addressable_shards if s.device == dev)
            np.testing.assert_array_equal(tflat[path].numpy(), np.asarray(shard.data))


def test_mesh_coordinates_follow_jax_device_grid():
    """A rank's coordinates are its index unravelled over (pp, dp, sp, ep,
    tp), the grid JAX reshapes its devices into."""
    jmesh = jmake_mesh(tp=2, dp=2, sp=2)
    grid = np.arange(8).reshape(1, 2, 2, 1, 2)
    for rank in range(8):
        m = Mesh.for_rank({"tp": 2, "dp": 2, "sp": 2}, rank)
        coords = tuple(m.coords[a] for a in AXIS_ORDER)
        assert grid[coords] == rank
        assert jmesh.devices[coords] == jmesh.devices.flat[rank]


def test_one_rank_mesh_and_errors():
    """Without a process group the mesh is one rank with no groups; JAX's
    errors for sizes the ranks cannot hold."""
    m = make_mesh()
    assert m.size == 1 and m.groups == {} and m.meta_group is None
    assert m.shape == {a: 1 for a in AXIS_ORDER}
    with pytest.raises(ValueError, match="not divisible by pp\\*dp\\*sp\\*ep"):
        make_mesh(dp=2)
    with pytest.raises(ValueError, match="needs 2 devices, have 1"):
        make_mesh(tp=2)
    with pytest.raises(ValueError, match="does not divide"):
        shard_tensor(torch.zeros(3, 4), ("tp",), Mesh.for_rank({"tp": 2}, 0))


@pytest.mark.parametrize("quantize", ["", "int8", "int4"])
@pytest.mark.parametrize("name,shape", [
    ("tiny-test", {"tp": 2}), ("tiny-moe", {"ep": 2, "tp": 2}), ("tiny-mla", {"tp": 2}),
])
def test_seeded_shards_are_slices_of_the_one_rank_model(name, shape, quantize):
    """``init_random`` at a mesh draws each full parameter from the
    generator of the one-rank model and keeps the rank's slice."""
    cfg = tconfig.get_config_preset(name)
    full = Llama(cfg, torch.float32, "cpu", seed=7, quantize=quantize).state_dict()
    n = int(np.prod(list(shape.values())))
    for rank in range(n):
        mesh = Mesh.for_rank(shape, rank)
        model = Llama(cfg, torch.float32, "cpu", seed=7, quantize=quantize, mesh=mesh)
        want = local_state(full, cfg, mesh, quantize)
        for k, v in model.state_dict().items():
            assert torch.equal(v, want[k]), (name, rank, k)
        # The local widths: H/tp heads, E/ep experts.
        layer = model.layers[-1]
        assert layer.heads == cfg.num_heads // shape.get("tp", 1)
        if cfg.moe is not None:
            assert layer.eg.shape[0] == cfg.moe.num_experts // shape["ep"]
            assert layer.expert0 == mesh.coords[AXES.ep] * layer.eg.shape[0]


def test_int4_groups_that_straddle_a_shard_raise():
    """A row-parallel int4 weight keeps the scale groups of its rows; a
    group across two ranks raises; one whole-axis group is kept whole."""
    cfg = tconfig.get_config_preset("tiny-test")
    state = Llama(cfg, torch.float32, "cpu", seed=1, quantize="int4").state_dict()
    mesh = Mesh.for_rank({"tp": 2}, 1)
    kept = local_state(state, cfg, mesh, "int4")
    assert torch.equal(kept["layers.0.wo.scale"], state["layers.0.wo.scale"])  # G = 1
    grouped = dict(state)
    grouped["layers.0.wd.scale"] = torch.arange(4 * cfg.hidden_size, dtype=torch.float32
                                                ).reshape(4, 1, cfg.hidden_size)
    got = local_state(grouped, cfg, mesh, "int4")["layers.0.wd.scale"]
    assert torch.equal(got, grouped["layers.0.wd.scale"][2:])
    grouped["layers.0.wd.scale"] = torch.ones(3, 1, cfg.hidden_size)
    with pytest.raises(ValueError, match="straddle"):
        local_state(grouped, cfg, mesh, "int4")


def test_sharded_model_refuses_what_does_not_divide():
    cfg = tconfig.get_config_preset("tiny-test")    # 2 kv heads
    with pytest.raises(ValueError, match="num_kv_heads=2 does not divide over 4"):
        Llama(cfg, torch.float32, "cpu", seed=0, mesh=Mesh.for_rank({"tp": 4}, 0))
    with pytest.raises(ValueError, match="needs a MoE model"):
        Llama(cfg, torch.float32, "cpu", seed=0, mesh=Mesh.for_rank({"ep": 2}, 0))
    with pytest.raises(ValueError, match="num_layers=2 not divisible by pp=4"):
        Llama(cfg, torch.float32, "cpu", seed=0, mesh=Mesh.for_rank({"pp": 4}, 0))


@pytest.mark.parametrize("shape", [{"dp": 2}, {"sp": 2}, {"pp": 2}, {"tp": 2}])
def test_training_refuses_a_mesh(shape):
    """``init_train_state`` accepts a mesh of several ranks (ROADMAP item
    11 (b)): rank 0's model holds the shard shapes ``train_param_specs``
    gives, from the seed or sliced from a whole model; a one-rank mesh is
    no mesh."""
    from opsagent_tpu_torch.parallel.pipeline import param_specs_pp
    from opsagent_tpu_torch.training.trainer import (
        TrainConfig,
        init_train_state,
        train_param_specs,
    )

    cfg = tconfig.get_config_preset("tiny-test")
    mesh = Mesh.for_rank(shape, 0)
    specs = train_param_specs(cfg, mesh)
    assert specs == (param_specs_pp(cfg) if "pp" in shape else param_specs(cfg))
    whole = Llama(cfg, torch.float32, "cpu", seed=0)
    full = {k: v.shape for k, v in whole.state_dict().items()}
    for model in (init_train_state(cfg, TrainConfig(), dtype=torch.float32, device="cpu",
                                   mesh=mesh)[0],
                  init_train_state(cfg, TrainConfig(), model=whole, mesh=mesh)[0]):
        assert model.mesh is mesh and all(p.requires_grad for p in model.parameters())
        got = {k: tuple(v.shape) for k, v in model.state_dict().items()}
        layers = sorted({int(k.split(".")[1]) for k in got if k.startswith("layers.")})
        # The stacked layer axis: pp-sharded stages hold L/pp layers.
        stacked = specs["layers"]["wq"][0]
        assert len(layers) == cfg.num_layers // (mesh.shape[stacked] if stacked else 1)
        for key, shp in got.items():
            leaf = key.rsplit(".", 1)[-1]
            spec = (specs["layers"][leaf][1:] if key.startswith("layers.")
                    else specs[key])
            want = tuple(n // (mesh.shape[a] if a else 1) for n, a in
                         zip(full[key], tuple(spec) + (None,) * len(shp)))
            assert shp == want, (shape, key)
    model, _ = init_train_state(cfg, TrainConfig(), dtype=torch.float32, device="cpu",
                                mesh=Mesh.for_rank({}, 0))
    assert model.mesh is None
