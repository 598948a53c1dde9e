"""The port never loads JAX or the JAX package, nor the tokenizer, checkpoint,
HTTP and YAML libraries the card machine lacks (``tokenizers``,
``transformers``, ``safetensors``, ``regex``, ``ml_dtypes``, ``aiohttp``,
``yaml``, ``tiktoken``).

Checked in a fresh interpreter: this process has JAX loaded already
(tests/conftest.py imports it).

A second check reads every module's source: no import statement anywhere in
it, a lazy one inside a function included, names one of those packages.
"""

import ast
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
                                    "ml_dtypes", "aiohttp", "yaml", "tiktoken"))
print(",".join(names), bad)
"""
# Modules each slice added; the walk must reach them.
REQUIRED = (
    "opsagent_tpu_torch.parallel.mesh",
    "opsagent_tpu_torch.parallel.collectives",
    "opsagent_tpu_torch.parallel.ring",
    "opsagent_tpu_torch.parallel.pipeline",
    "opsagent_tpu_torch.serving.spmd",
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
    "opsagent_tpu_torch.serving.faults",
    "opsagent_tpu_torch.serving.decode_loop",
    "opsagent_tpu_torch.training",
    "opsagent_tpu_torch.training.trainer",
    "opsagent_tpu_torch.training.checkpoint",
    "opsagent_tpu_torch.training.parity",
    "opsagent_tpu_torch.native",
    "opsagent_tpu_torch.utils.globalstore",
    "opsagent_tpu_torch.utils.yamlutil",
    "opsagent_tpu_torch.utils.yamlio",
    "opsagent_tpu_torch.utils.term",
    "opsagent_tpu_torch.utils.config",
    "opsagent_tpu_torch.llm.tokens",
    "opsagent_tpu_torch.tools",
    "opsagent_tpu_torch.tools.proc",
    "opsagent_tpu_torch.tools.kubectl",
    "opsagent_tpu_torch.tools.python_tool",
    "opsagent_tpu_torch.tools.trivy",
    "opsagent_tpu_torch.tools.jq",
    "opsagent_tpu_torch.tools.search",
    "opsagent_tpu_torch.tools.replay",
    "opsagent_tpu_torch.k8s",
    "opsagent_tpu_torch.k8s.client",
    "opsagent_tpu_torch.agent",
    "opsagent_tpu_torch.agent.prompts",
    "opsagent_tpu_torch.agent.funcall",
    "opsagent_tpu_torch.agent.react",
    "opsagent_tpu_torch.agent.conveyor",
    "opsagent_tpu_torch.workflows",
    "opsagent_tpu_torch.workflows.flows",
    "opsagent_tpu_torch.server",
    "opsagent_tpu_torch.server.jwtauth",
    "opsagent_tpu_torch.server.handlers",
    "opsagent_tpu_torch.server.app",
    "opsagent_tpu_torch.cli",
    "opsagent_tpu_torch.cli.main",
    "opsagent_tpu_torch.__main__",
    "opsagent_tpu_torch.serving.fleet.registry",
    "opsagent_tpu_torch.serving.fleet.pagestore",
    "opsagent_tpu_torch.serving.fleet.client",
    "opsagent_tpu_torch.serving.fleet.router",
    "opsagent_tpu_torch.cli.top",
    "opsagent_tpu_torch.cli.slocheck",
    "opsagent_tpu_torch.cli.perfcheck",
    "opsagent_tpu_torch.serving.fleet.autoscale",
    "opsagent_tpu_torch.agent.fanout",
    "opsagent_tpu_torch.agent.fanout.orchestrator",
    "opsagent_tpu_torch.agent.fanout.synthcluster",
    "opsagent_tpu_torch.cli.fanout",
)
BANNED = ("jax", "jaxlib", "opsagent_tpu", "tokenizers", "transformers", "safetensors",
          "regex", "ml_dtypes", "aiohttp", "yaml", "tiktoken")


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


def test_port_sources_import_no_banned_package_even_lazily():
    root = os.path.join(REPO, "opsagent_tpu_torch")
    found = []
    for dirpath, _, files in os.walk(root):
        for f in files:
            if not f.endswith(".py"):
                continue
            path = os.path.join(dirpath, f)
            with open(path, encoding="utf-8") as fh:
                tree = ast.parse(fh.read(), path)
            for node in ast.walk(tree):
                if isinstance(node, ast.Import):
                    names = [a.name for a in node.names]
                elif isinstance(node, ast.ImportFrom) and node.level == 0:
                    names = [node.module or ""]
                else:
                    continue
                found += [(os.path.relpath(path, REPO), n) for n in names
                          if n.split(".")[0] in BANNED]
    assert found == []
