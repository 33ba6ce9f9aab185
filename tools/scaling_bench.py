"""Scaling-efficiency harness: pipeline throughput vs mesh size.

Measures the full sharded pipeline step (encode -> channel -> sync w/ halo
exchange -> decode -> psum'd BER) on 1..N devices with the per-device batch
held constant (weak scaling).  On several GPUs this produces the north
star's scaling-efficiency numbers; without them it runs over the fake CPU
device mesh to validate the methodology and the collectives
(`XLA_FLAGS=--xla_force_host_platform_device_count=8 python tools/scaling_bench.py`).
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax
import jax.numpy as jnp
import numpy as np


_DTYPE_BYTES = {"f32": 4, "c64": 8, "f64": 8, "c128": 16, "u8": 1, "s32": 4,
                "u32": 4, "pred": 1, "bf16": 2, "s8": 1, "u64": 8, "s64": 8}


def _collective_inventory(compiled_text):
    """Collective op counts + per-device per-step operand bytes (the
    quantified comm volume; same counter as tests/test_parallel.py)."""
    import re
    counts = {}
    byte_totals = {}
    for name in ("all-gather", "all-to-all", "reduce-scatter",
                 "collective-permute", "all-reduce"):
        pat = rf"= (?:\()?((?:\w+\[[\d,]*\][^ ]*(?:, )?)+)\)? {name}(?:-start)?\("
        total = 0
        n = 0
        for m in re.finditer(pat, compiled_text):
            n += 1
            for dt, dims in re.findall(r"(\w+)\[([\d,]*)\]", m.group(1)):
                elems = int(np.prod([int(d) for d in dims.split(",") if d]
                                    or [1]))
                total += elems * _DTYPE_BYTES.get(dt, 8)
        counts[name] = n
        byte_totals[name] = total
    counts["total_bytes"] = sum(byte_totals.values())
    return counts


def bench_mesh(n_devices: int, per_device_batch: int = 8,
               payload_len: int = 512, reps: int = 20):
    import ofdm_tpu as ot
    from ofdm_tpu.parallel.mesh import make_mesh
    from ofdm_tpu.parallel.pipeline import make_pipeline_step

    n_time = 2 if n_devices % 2 == 0 else 1
    mesh = make_mesh(n_data=n_devices // n_time, n_time=n_time)
    # timing_error off: the random CFO draw can land at the Schmidl-Cox
    # aliasing boundary for some rows (a documented reference-shared failure
    # mode, tests/test_loopback.py) — not what this harness measures.
    step = make_pipeline_step(mesh, payload_len=payload_len, guard_bands=True,
                              modulation=ot.Modulation.QPSK, snr=30.0,
                              timing_error=False)
    batch = per_device_batch * n_devices
    rng = np.random.default_rng(0)
    data = jnp.asarray(rng.integers(0, 256, (batch, payload_len), dtype=np.uint8))
    key = jax.random.key(0)
    decoded, errs = step(data, key)
    jax.block_until_ready(decoded)
    assert int(errs) == 0, f"{int(errs)} bit errors on {n_devices} devices"

    t0 = time.perf_counter()
    for _ in range(reps):
        decoded, errs = step(data, key)
    jax.block_until_ready(decoded)
    dt = (time.perf_counter() - t0) / reps
    frames_per_s = batch / dt
    comm = _collective_inventory(
        step.lower(data, key).compile().as_text())
    return {"devices": n_devices, "batch": batch, "sec_per_step": dt,
            "frames_per_s": frames_per_s, "collectives_per_step": comm}


def bench_two_process_cluster():
    """Real two-OS-process gloo cluster (4x2 global mesh over 8 CPU devices)
    — the jax.distributed path a multi-host job uses; records parity + wall
    time."""
    import socket
    import subprocess
    import tempfile

    tmpdir = tempfile.mkdtemp(prefix="scaling_cluster")
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    worker = os.path.join(os.path.dirname(__file__), "dist_worker.py")
    outs = [os.path.join(tmpdir, f"rank{r}.json") for r in range(2)]
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, worker, "--rank", str(r), "--nprocs", "2",
         "--port", str(port), "--out", outs[r]], env=env,
        stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
        for r in range(2)]
    rcs = [p.wait(timeout=600) for p in procs]
    wall = time.perf_counter() - t0
    reports = [json.load(open(o)) for o in outs]
    return {"processes": 2, "global_devices": reports[0].get("n_global"),
            "mesh_shape": reports[0].get("mesh_shape"),
            "all_ok": all(r.get("ok") for r in reports) and rcs == [0, 0],
            "bit_errors": sum(r.get("bit_errors", -1) for r in reports),
            "wall_s_incl_startup": wall}


def main():
    n_avail = len(jax.devices())
    sizes = [n for n in (1, 2, 4, 8, 16) if n <= n_avail]
    results = [bench_mesh(n) for n in sizes]
    base = results[0]["frames_per_s"]
    for r in results:
        r["scaling_efficiency"] = r["frames_per_s"] / (base * r["devices"])
    out = {"platform": jax.default_backend(), "results": results}
    if jax.default_backend() == "cpu":
        out["note"] = ("fake CPU devices share one physical host: efficiency "
                       "numbers here only validate the mechanism; real "
                       "scaling needs several GPUs")
        try:
            out["two_process_cluster"] = bench_two_process_cluster()
        except Exception as e:
            out["two_process_cluster"] = {"error": repr(e)[:300]}
    print(json.dumps(out, indent=2))


if __name__ == "__main__":
    main()
