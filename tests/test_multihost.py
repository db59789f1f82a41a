"""Real multi-process (multi-controller) test of dist/multihost.py.

Spawns TWO separate JAX processes with 4 virtual CPU devices each, joined
through jax.distributed over a localhost coordinator — the inter-process
collective legs are the DCN plane of SURVEY.md §5.8 carried by gRPC. The
worker (scripts/multihost_worker.py) checks: global 8-device mesh, a
cross-process psum, and a sharded trace whose assembled film matches the
single-process render exactly.
"""

import os
import socket
import subprocess
import sys


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "scripts", "multihost_worker.py")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_mesh_psum_render():
    # subprocess.communicate(timeout=540) below bounds the runtime
    coord = f"127.0.0.1:{_free_port()}"
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env.pop("XLA_FLAGS", None)
    # the workers are CPU-only and import the package from this checkout
    env["PYTHONPATH"] = REPO
    procs = [
        subprocess.Popen(
            [sys.executable, WORKER, coord, "2", str(pid)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            env=env, cwd=REPO,
        )
        for pid in range(2)
    ]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=540)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append(out)
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"proc {pid} failed:\n{out}"
        for mark in ("PASS mesh 8 devices", "PASS psum", "PASS render"):
            assert mark in out, f"proc {pid} missing {mark!r}:\n{out}"
