"""The port's demo harness (``tools/demo_cluster_torch.py``) against the
reference's (``tools/demo_cluster.py``), each a process of its own on a
free port, fed the same stdin lines (``w1 8``, ``huge 99``, ``ring 4c``:
an HBM slice that binds, one no node holds, and four whole chips): the
same answer to each line, the same ``/tpushare-scheduler/inspect``
document, and ``/healthz`` answers.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import time
import urllib.request

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LINES = ("w1 8", "huge 99", "ring 4c")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _get(port: int, path: str) -> tuple[int, bytes]:
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=10) as resp:
        return resp.status, resp.read()


def _drive(tool: str) -> tuple[list[str], dict, bytes]:
    """Start ``tool``, feed it ``LINES`` once it listens; its answers,
    its settled inspect document and its ``/healthz`` body."""
    port = _free_port()
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO)
    proc = subprocess.Popen(
        [sys.executable, os.path.join("tools", tool), "--port", str(port),
         "--nodes", "2"], cwd=REPO, env=env, stdin=subprocess.PIPE,
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    try:
        banner = proc.stdout.readline()
        assert f"127.0.0.1:{port}" in banner, banner
        proc.stdout.readline()  # the usage line
        answers = []
        for line in LINES:
            proc.stdin.write(line + "\n")
            proc.stdin.flush()
            answers.append(proc.stdout.readline().strip())
        status, health = _get(port, "/healthz")
        assert status == 200
        # The informer settles the binds into the ledger: read until two
        # reads agree.
        deadline = time.monotonic() + 10
        last = None
        while True:
            doc = json.loads(_get(port, "/tpushare-scheduler/inspect")[1])
            if doc == last or time.monotonic() > deadline:
                break
            last = doc
            time.sleep(0.2)
        return answers, doc, health
    finally:
        proc.stdin.close()
        try:
            proc.wait(timeout=20)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()


def test_demo_twin_answers_as_the_reference():
    want = _drive("demo_cluster.py")
    got = _drive("demo_cluster_torch.py")
    answers, inspect, health = got
    assert answers[0].startswith("pod w1: bound to v5e-")
    assert answers[1].startswith("pod huge: unschedulable")
    assert answers == want[0]
    assert inspect == want[1]
    assert sum(len(c["pods"]) for n in inspect["nodes"]
               for c in n["chips"]) >= 1
    assert health.startswith(b"ok")
    assert health == want[2]
