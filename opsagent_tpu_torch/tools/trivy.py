"""trivy tool: container image vulnerability scanning (the port's copy of
``opsagent_tpu/tools/trivy.py``): strips an optional ``image `` prefix and
runs ``trivy image <img> --scanners vuln``.
"""

from __future__ import annotations

import subprocess

from . import ToolError, proc

# Conveyor launch readiness (agent/conveyor.py): the image name is the
# only argument the scanner needs to start.
LAUNCH_FIELDS = ("image",)


def trivy(image: str, timeout: float = 300.0) -> str:
    img = image.strip()
    if img.startswith("image "):
        img = img[len("image ") :].strip()
    if not img:
        raise ToolError("no image name given to trivy")
    try:
        res = proc.run(
            ["trivy", "image", img, "--scanners", "vuln"], timeout=timeout
        )
    except FileNotFoundError as e:
        raise ToolError(f"trivy not available: {e}") from e
    except subprocess.TimeoutExpired as e:
        raise ToolError(f"trivy timed out after {timeout}s") from e
    if res.returncode != 0:
        raise ToolError(res.stderr.strip() or f"trivy exited with {res.returncode}")
    return res.stdout.strip() or "(no output)"
