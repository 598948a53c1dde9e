"""kubectl replay shims: canned cluster output without a cluster (the port's
copy of ``opsagent_tpu/tools/replay.py``).

The tool layer runs commands through ``bash -c`` (tools/kubectl.py), so a
script named ``kubectl`` earlier on PATH serves recorded transcripts. The
scripts are the ones ``scripts/train_tiny_agent.py`` trains against, so a
served observation matches the trained one byte for byte.
"""

from __future__ import annotations

import os
import stat
import tempfile

# Three namespaces; `... --no-headers | wc -l` pipelines yield "3".
NAMESPACES_SCRIPT = (
    "#!/bin/bash\n"
    "printf 'default\\nkube-system\\nmonitoring\\n'\n"
)

# Wider surface for freeform questions (namespace + pod verbs).
CLUSTER_SCRIPT = """#!/bin/bash
args="$*"
case "$args" in
  *namespace*)
    printf 'default\\nkube-system\\nkube-public\\nmonitoring\\n' ;;
  *pod*)
    printf 'web-1   Running\\nweb-2   CrashLoopBackOff\\n' ;;
  *)
    printf 'replay: no canned output for: %s\\n' "$args" >&2; exit 1 ;;
esac
"""

# Fixed mini-cluster for the MULTI-instruction trained-agent demo
# (scripts/train_tiny_agent.py --tasks multi): namespaces, pods (all/-n
# default), nodes, and version — every command the task corpus trains
# on answers byte-exactly here, so served observations match training.
MULTI_TASK_SCRIPT = """#!/bin/bash
args="$*"
case "$args" in
  *"get namespaces"*)
    printf 'default\\nkube-system\\nmonitoring\\n' ;;
  *"get nodes"*)
    printf 'node-a   Ready\\nnode-b   Ready\\nnode-c   NotReady\\n' ;;
  *version*)
    printf 'Server Version: v1.29.3\\n' ;;
  *"get pods -n default"*)
    printf 'web-1   Running\\napi-1   Running\\n' ;;
  *"get pods"*)
    printf 'web-1   Running\\nweb-2   CrashLoopBackOff\\n' ;;
  *)
    printf 'replay: no canned output for: %s\\n' "$args" >&2; exit 1 ;;
esac
"""


def install_replay_kubectl(
    script: str = NAMESPACES_SCRIPT, tooldir: str | None = None
) -> str:
    """Write a replay ``kubectl`` and prepend its dir to PATH.

    Returns the tool dir. Mutates ``os.environ['PATH']`` for the current
    process (subprocesses spawned by the tool layer inherit it).
    """
    tooldir = tooldir or tempfile.mkdtemp(prefix="opsagent-replay-")
    os.makedirs(tooldir, exist_ok=True)
    path = os.path.join(tooldir, "kubectl")
    with open(path, "w", encoding="utf-8") as f:
        f.write(script)
    os.chmod(path, os.stat(path).st_mode | stat.S_IEXEC)
    os.environ["PATH"] = tooldir + os.pathsep + os.environ["PATH"]
    return tooldir
