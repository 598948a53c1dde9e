"""python tool: execute a Python script and return stdout (the port's copy of
``opsagent_tpu/tools/python_tool.py``). The script runs under the k8s ops
venv's interpreter when ``~/k8s/python-cli/k8s-env`` exists, else the
current one; it is passed via argv, so no shell quoting is involved.
"""

from __future__ import annotations

import os
import subprocess
import sys

from . import ToolError, proc

_VENV_PY = os.path.expanduser("~/k8s/python-cli/k8s-env/bin/python3")

# Conveyor launch readiness (agent/conveyor.py): the script body is the
# only argument needed to start the interpreter.
LAUNCH_FIELDS = ("script",)


def interpreter() -> str:
    return _VENV_PY if os.path.isfile(_VENV_PY) else sys.executable


def python_repl(script: str, timeout: float = 120.0) -> str:
    try:
        res = proc.run(
            [interpreter(), "-c", script],
            timeout=timeout,
            cwd=os.path.expanduser("~"),
        )
    except subprocess.TimeoutExpired as e:
        raise ToolError(f"python script timed out after {timeout}s") from e
    if res.returncode != 0:
        raise ToolError(res.stderr.strip() or f"python exited with {res.returncode}")
    out = res.stdout.strip()
    return out if out else "(no output)"
