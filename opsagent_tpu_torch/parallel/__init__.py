"""The device mesh and its collectives (the port's ``opsagent_tpu/parallel``):
``mesh`` (axes, process groups, ``shard_params``), ``collectives`` (the
forward collectives over one axis) and ``ring`` (ragged ring attention)."""

from .mesh import AXES, Mesh, MeshAxes, init_distributed, make_mesh, shard_params

__all__ = ["AXES", "Mesh", "MeshAxes", "init_distributed", "make_mesh", "shard_params"]
