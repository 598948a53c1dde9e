"""OpsAgent's serving engine in PyTorch, with hand-written CUDA kernels for
NVIDIA Hopper (H100).

This package mirrors ``opsagent_tpu``'s layout (``models/llama.py`` here is
the counterpart of ``opsagent_tpu/models/llama.py``) but imports nothing from
it and never imports JAX. Entry points run on ``cuda`` unless the caller asks
for ``device="cpu"``; see ``device.resolve_device``.
"""

__version__ = "0.1.0"

# The version the agent CLI and /api/version report (the JAX package's).
VERSION = "v0.1.0"
