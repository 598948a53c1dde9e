"""The device mesh and its collectives (the port's ``opsagent_tpu/parallel``):
``mesh`` (axes, process groups, ``shard_params``), ``collectives`` (the
collectives over one axis and their differentiable forms), ``ring``
(ragged ring attention and its backward) and ``pipeline`` (GPipe stages
for training)."""

from .mesh import AXES, Mesh, MeshAxes, init_distributed, make_mesh, shard_params

__all__ = ["AXES", "Mesh", "MeshAxes", "init_distributed", "make_mesh", "shard_params"]
