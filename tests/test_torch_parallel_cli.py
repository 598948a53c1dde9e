"""``serve-engine --nproc 2 --tp 2`` on the CPU: the CLI spawns two ranks
under torch's launch variables over gloo, rank 0 binds the port and
serves, and ``/healthz`` reports the mesh. Terminating the launcher stops
both ranks. ``snapshot create --tp 2 --nproc 2`` writes a snapshot at the
mesh, which ``serve-engine --restore-snapshot DIR --nproc 2`` serves."""

import json
import os
import subprocess
import sys
import time
import urllib.request

from _torch_spmd_kit import REPO, free_port

ENV = {**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "1"}


def _get(url, body=None, timeout=5):
    req = urllib.request.Request(url, data=None if body is None else json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


def _serve(tmp_path, args: list[str], name: str = "serve") -> dict:
    """``serve-engine --nproc 2 ... args`` on a free port: its ``/healthz``
    and one greedy reply; the launcher is terminated after, and no rank
    may outlive it."""
    port = free_port()
    log = open(tmp_path / f"{name}.log", "w")
    proc = subprocess.Popen(
        [sys.executable, "-m", "opsagent_tpu_torch", "serve-engine", "--nproc", "2",
         "--eager", "--dist-backend", "gloo", "--device", "cpu",
         "--host", "127.0.0.1", "--port", str(port), *args],
        cwd=REPO, env=ENV, stdout=log, stderr=subprocess.STDOUT)
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
        assert health is not None, (tmp_path / f"{name}.log").read_text()[-3000:]
        reply = _get(url + "/v1/chat/completions", {
            "messages": [{"role": "user", "content": "hi"}], "max_tokens": 8,
            "temperature": 0}, timeout=60)
    finally:
        proc.terminate()
        proc.wait(timeout=60)
        log.close()
    assert not _ranks_of(port), "a rank outlived the launcher"
    return {"health": health, "reply": reply}


def test_serve_engine_spawns_two_ranks_and_serves(tmp_path):
    got = _serve(tmp_path, ["--tp", "2", "--model-name", "tiny-test"])
    assert got["health"]["impl"]["mesh"] == "tp=2"
    assert got["reply"]["usage"]["completion_tokens"] == 8


def test_snapshot_created_at_tp2_verifies_and_serves_restored_at_tp2(tmp_path):
    """``snapshot create --tp 2 --nproc 2`` writes whole leaves from rank 0
    (``snapshot verify`` passes, the manifest records the mesh), and
    ``serve-engine --restore-snapshot DIR --nproc 2`` serves it at tp = 2
    with the replies of the engine it was taken from."""
    snap = str(tmp_path / "snap")
    run = subprocess.run(
        [sys.executable, "-m", "opsagent_tpu_torch", "snapshot", "create", "--out", snap,
         "--model-name", "tiny-test", "--device", "cpu", "--tp", "2", "--nproc", "2",
         "--eager", "--dist-backend", "gloo"],
        cwd=REPO, env=ENV, capture_output=True, text=True, timeout=120)
    assert run.returncode == 0, run.stdout[-2000:] + run.stderr[-3000:]
    assert json.loads(run.stdout[run.stdout.index("{"):])["leaves"] > 0
    verify = subprocess.run(
        [sys.executable, "-m", "opsagent_tpu_torch", "snapshot", "verify", snap],
        cwd=REPO, env=ENV, capture_output=True, text=True, timeout=60)
    assert verify.returncode == 0, verify.stdout[-2000:]
    with open(os.path.join(snap, "manifest.json")) as f:
        man = json.load(f)
    assert man["engine"]["tp"] == 2 and man["torch"]["mesh"]["tp"] == 2
    restored = _serve(tmp_path, ["--restore-snapshot", snap], "restored")
    assert restored["health"]["impl"]["mesh"] == "tp=2"
    fresh = _serve(tmp_path, ["--tp", "2", "--model-name", "tiny-test"], "fresh")
    assert (restored["reply"]["choices"][0]["message"]["content"]
            == fresh["reply"]["choices"][0]["message"]["content"])


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
