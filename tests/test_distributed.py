"""Two-process jax.distributed smoke test (the multi-host path).

The reference has no multi-node runtime at all (SLURM array jobs only);
this framework's multi-host story is ``jax.distributed`` + meshes spanning
hosts.  Real multi-host hardware is unavailable here, so two local
processes with 2 virtual CPU devices each stand in: they must join one
runtime, form a 2x2 (data x space) mesh across the process boundary, and
agree on cross-process collective results (see distributed_worker.py).
"""

import os
import socket
import subprocess
import sys

import pytest

_WORKER = os.path.join(os.path.dirname(__file__), "distributed_worker.py")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.mark.slow
def test_two_process_mesh():
    port = _free_port()
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)  # workers pin their own device counts
    procs = [subprocess.Popen(
        [sys.executable, _WORKER, str(i), "2", str(port)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env) for i in range(2)]
    outs = []
    for p in procs:
        try:
            # budget: the cross-process spatial encode compiles the full
            # pipeline in both workers (~2-4 min cold on this 1-core host;
            # the persistent compile cache makes re-runs fast)
            out, _ = p.communicate(timeout=900)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append(out)
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {i} failed:\n{out}"
        assert f"OK process {i}/2" in out, out
        assert f"sharded-encode ok process {i}/2" in out, out
