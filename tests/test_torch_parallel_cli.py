"""``serve-engine --nproc 2 --tp 2`` on the CPU: the CLI spawns two ranks
under torch's launch variables over gloo, rank 0 binds the port and
serves, and ``/healthz`` reports the mesh. Terminating the launcher stops
both ranks."""

import json
import os
import subprocess
import sys
import time
import urllib.request

from _torch_spmd_kit import REPO, free_port


def _get(url, body=None, timeout=5):
    req = urllib.request.Request(url, data=None if body is None else json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


def test_serve_engine_spawns_two_ranks_and_serves(tmp_path):
    port = free_port()
    log = open(tmp_path / "serve.log", "w")
    proc = subprocess.Popen(
        [sys.executable, "-m", "opsagent_tpu_torch", "serve-engine", "--nproc", "2",
         "--tp", "2", "--eager", "--dist-backend", "gloo", "--device", "cpu",
         "--model-name", "tiny-test", "--host", "127.0.0.1", "--port", str(port)],
        cwd=REPO, env={**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "1"},
        stdout=log, stderr=subprocess.STDOUT)
    url = f"http://127.0.0.1:{port}"
    try:
        deadline = time.monotonic() + 60
        health = None
        while time.monotonic() < deadline and proc.poll() is None:
            try:
                health = _get(url + "/healthz")
                break
            except OSError:
                time.sleep(0.5)
        assert health is not None, (tmp_path / "serve.log").read_text()[-3000:]
        assert health["impl"]["mesh"] == "tp=2"
        reply = _get(url + "/v1/chat/completions", {
            "messages": [{"role": "user", "content": "hi"}], "max_tokens": 8,
            "temperature": 0}, timeout=60)
        assert reply["usage"]["completion_tokens"] == 8
    finally:
        proc.terminate()
        proc.wait(timeout=60)
        log.close()
    assert not _ranks_of(port), "a rank outlived the launcher"


def _ranks_of(port: int) -> list[int]:
    """Processes whose command line serves ``port``."""
    found = []
    for pid in filter(str.isdigit, os.listdir("/proc")):
        try:
            with open(f"/proc/{pid}/cmdline", "rb") as f:
                args = f.read().split(b"\0")
        except OSError:
            continue
        if b"serve-engine" in args and str(port).encode() in args:
            found.append(int(pid))
    return found
