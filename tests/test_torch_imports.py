"""The port never loads JAX or the JAX package, nor the tokenizer and
checkpoint libraries the card machine lacks (``tokenizers``,
``transformers``, ``safetensors``, ``regex``, ``ml_dtypes``).

Checked in a fresh interpreter: this process has JAX loaded already
(tests/conftest.py imports it).
"""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PROBE = """
import importlib, pkgutil, sys
import opsagent_tpu_torch
names = [m.name for m in pkgutil.walk_packages(
    opsagent_tpu_torch.__path__, "opsagent_tpu_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "opsagent_tpu", "tokenizers",
                                    "transformers", "safetensors", "regex",
                                    "ml_dtypes"))
print(",".join(names), bad)
"""
# Modules each slice added; the walk must reach them.
REQUIRED = (
    "opsagent_tpu_torch.ops.paged_attention",
    "opsagent_tpu_torch.ops.cuda_build",
    "opsagent_tpu_torch.ops.quant_matmul",
    "opsagent_tpu_torch.models.config",
    "opsagent_tpu_torch.models.llama",
    "opsagent_tpu_torch.models.quant",
    "opsagent_tpu_torch.models.convert",
    "opsagent_tpu_torch.models.loader",
    "opsagent_tpu_torch.serving.constrained",
    "opsagent_tpu_torch.serving.tokenizer",
    "opsagent_tpu_torch.utils.jsonrepair",
    "opsagent_tpu_torch.utils.logger",
    "opsagent_tpu_torch.utils.perf",
    "opsagent_tpu_torch.utils.profiling",
    "opsagent_tpu_torch.obs",
    "opsagent_tpu_torch.obs.metrics",
    "opsagent_tpu_torch.obs.trace",
    "opsagent_tpu_torch.obs.flight",
    "opsagent_tpu_torch.obs.slo",
    "opsagent_tpu_torch.obs.attribution",
    "opsagent_tpu_torch.obs.timeline",
    "opsagent_tpu_torch.obs.history",
    "opsagent_tpu_torch.serving.async_runtime",
    "opsagent_tpu_torch.llm",
    "opsagent_tpu_torch.llm.client",
    "opsagent_tpu_torch.serving.offload",
    "opsagent_tpu_torch.serving.offload.pool",
    "opsagent_tpu_torch.serving.offload.copy",
    "opsagent_tpu_torch.serving.offload.manager",
    "opsagent_tpu_torch.serving.fleet",
    "opsagent_tpu_torch.serving.fleet.transfer",
    "opsagent_tpu_torch.serving.snapshot",
    "opsagent_tpu_torch.serving.snapshot.manifest",
    "opsagent_tpu_torch.serving.snapshot.writer",
    "opsagent_tpu_torch.serving.snapshot.restore",
)


def test_port_imports_no_jax_and_no_jax_package():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run(
        [sys.executable, "-c", PROBE], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert res.returncode == 0, res.stderr
    names, bad = res.stdout.strip().split(" ", 1)
    names = names.split(",")
    assert len(names) >= 20          # every module of the package was imported
    assert set(REQUIRED) <= set(names)
    assert bad == "[]"
