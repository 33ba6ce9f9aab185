"""Real multi-process jax.distributed validation.

Launches TWO separate OS processes on localhost (coordinator + worker, CPU
backend with 4 virtual devices each = an 8-device cluster) and runs the full
sequence-parallel pipeline step over a global 4x2 mesh with gloo
cross-process collectives.  This exercises the exact code path a multi-host
job uses — `parallel.distributed.initialize` / `global_mesh` — which in-process
virtual-device tests cannot: coordinator handshake, global device discovery,
and collectives crossing a process boundary.
"""

import json
import os
import socket
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tools", "dist_worker.py")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.mark.slow
def test_two_process_pipeline_parity(tmp_path):
    port = _free_port()
    # each rank sets its own platform and virtual device count
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    outs = [tmp_path / f"rank{r}.json" for r in range(2)]
    procs = [
        subprocess.Popen(
            [sys.executable, WORKER, "--rank", str(r), "--nprocs", "2",
             "--port", str(port), "--out", str(outs[r])],
            env=env, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE)
        for r in range(2)]
    rcs = [p.wait(timeout=300) for p in procs]
    for r, (p, rc) in enumerate(zip(procs, rcs)):
        stderr = p.stderr.read().decode(errors="replace")
        assert rc == 0, f"rank {r} exited {rc}; stderr:\n{stderr}"

    reports = [json.loads(o.read_text()) for o in outs]
    for rep in reports:
        assert rep["ok"], f"rank {rep['rank']} failed:\n{rep.get('error')}"
        assert rep["started"] and rep["process_count"] == 2
        assert rep["n_local"] == 4 and rep["n_global"] == 8
        assert rep["mesh_shape"] == {"data": 4, "time": 2}
        assert rep["bit_errors"] == 0
        assert rep["psum_total"] == 8.0          # crossed the process boundary
    assert {r["process_index"] for r in reports} == {0, 1}
    # every batch row was byte-checked by exactly one process's shards
    assert sum(r["rows_checked"] for r in reports) == 16
