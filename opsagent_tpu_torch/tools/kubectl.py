"""kubectl tool: run kubectl command lines through a shell (the port's copy of
``opsagent_tpu/tools/kubectl.py``): prepends ``kubectl`` when missing,
executes via ``bash -c`` so pipes work, counts calls by verb, and filters
noisy apiserver/klog error lines from the output.
"""

from __future__ import annotations

import re
import subprocess

from . import ToolError, proc
from ..utils.perf import get_perf_stats

# Conveyor launch readiness (agent/conveyor.py): the shell line is the
# only argument kubectl needs to start.
LAUNCH_FIELDS = ("command",)

_VERBS = ("get", "describe", "logs", "exec", "apply", "delete", "top", "create", "patch")

# klog-style lines (E0307 12:34:56.789 ...) and known-noisy apiserver chatter.
_NOISE = re.compile(
    r"^[EWIF]\d{4} \d{2}:\d{2}:\d{2}\.\d+"
    r"|couldn't get current server API group list"
    r"|metrics\.k8s\.io.*(unavailable|error)"
    r"|the server is currently unable to handle the request \(get .*metrics"
)


def _classify(cmd: str) -> str:
    for verb in _VERBS:
        if re.search(rf"\bkubectl(\s+\S+)*\s+{verb}\b", cmd) or cmd.strip().startswith(verb):
            return verb
    return "other"


def filter_noise(output: str) -> str:
    kept = [ln for ln in output.splitlines() if not _NOISE.search(ln.strip())]
    return "\n".join(kept).strip()


def kubectl(command: str, timeout: float = 90.0) -> str:
    cmd = command.strip()
    if not cmd.startswith("kubectl"):
        cmd = "kubectl " + cmd
    ps = get_perf_stats()
    ps.record_metric(f"tool.kubectl.{_classify(cmd)}", 1, "calls")
    with ps.timer("tool.kubectl"):
        try:
            res = proc.run(["bash", "-c", cmd], timeout=timeout)
        except FileNotFoundError as e:
            raise ToolError(f"kubectl not available: {e}") from e
        except subprocess.TimeoutExpired as e:
            raise ToolError(f"kubectl timed out after {timeout}s: {cmd}") from e
    out = filter_noise(res.stdout)
    err = filter_noise(res.stderr)
    if res.returncode != 0:
        raise ToolError(err or out or f"kubectl exited with {res.returncode}")
    result = out or err
    return result if result else "(no output)"
