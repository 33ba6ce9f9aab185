"""Multi-process distributed worker (one rank of a localhost cluster).

Exercises the REAL ``jax.distributed`` runtime path (parallel/distributed.py)
that a multi-host job uses — coordinator handshake, global device discovery,
``global_mesh`` over all processes, and the full sequence-parallel
``pipeline_step`` with cross-process collectives (gloo on the CPU backend) —
with byte parity against the same step computed single-process.

Launched (one process per rank) by tests/test_distributed.py:

    python tools/dist_worker.py --rank R --nprocs N --port P --out out_R.json

Each rank forces the CPU backend with 4 virtual devices, so N=2 ranks form
an 8-device cluster on one host without an accelerator.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import traceback


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--nprocs", type=int, required=True)
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--devices-per-proc", type=int, default=4)
    args = ap.parse_args()

    report: dict = {"rank": args.rank, "ok": False}
    try:
        os.environ["XLA_FLAGS"] = (
            os.environ.get("XLA_FLAGS", "")
            + f" --xla_force_host_platform_device_count={args.devices_per_proc}")
        import jax
        jax.config.update("jax_platforms", "cpu")

        sys.path.insert(0, os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        from ofdm_tpu.parallel.distributed import global_mesh, initialize

        started = initialize(coordinator=f"localhost:{args.port}",
                             num_processes=args.nprocs, process_id=args.rank)
        report["started"] = bool(started)
        report["process_index"] = int(jax.process_index())
        report["process_count"] = int(jax.process_count())
        report["n_local"] = len(jax.local_devices())
        report["n_global"] = len(jax.devices())
        assert report["process_count"] == args.nprocs
        assert report["n_local"] == args.devices_per_proc
        assert report["n_global"] == args.nprocs * args.devices_per_proc

        # global mesh spanning BOTH processes: data=4 x time=2 over 8 devices
        mesh = global_mesh(n_time=2)
        report["mesh_shape"] = dict(mesh.shape)

        import numpy as np
        import jax.numpy as jnp
        from jax.sharding import NamedSharding, PartitionSpec as P

        import ofdm_tpu as ot
        from ofdm_tpu.parallel.pipeline import make_pipeline_step

        step = make_pipeline_step(mesh, payload_len=48, guard_bands=True,
                                  modulation=ot.Modulation.QPSK, snr=30.0,
                                  timing_error=True)
        rng = np.random.default_rng(9)       # same data on every rank
        batch = 2 * mesh.shape["data"]
        data_np = rng.integers(0, 256, (batch, 48), dtype=np.uint8)
        data_sh = NamedSharding(mesh, P("data", None))
        data = jax.make_array_from_callback(
            data_np.shape, data_sh, lambda idx: data_np[idx])
        # replicated global key (device_put can't target non-addressable
        # devices; the multihost helper assembles the global array from
        # per-process local puts)
        from jax.experimental import multihost_utils
        key = multihost_utils.host_local_array_to_global_array(
            jax.random.key(3), mesh, P())

        decoded, errs = step(data, key)
        jax.block_until_ready(decoded)
        report["bit_errors"] = int(errs)
        assert report["bit_errors"] == 0

        # byte parity of this rank's addressable rows vs the payload they
        # carry (the single-process equivalence of the same step is locked by
        # tests/test_timeshard.py; here the cross-process collectives ran)
        for shard in decoded.addressable_shards:
            rows = shard.index[0]
            got = np.asarray(shard.data)[:, 16:16 + 48]
            want = data_np[rows]
            assert np.array_equal(got, want), "decoded payload mismatch"
        report["rows_checked"] = sum(
            s.data.shape[0] for s in decoded.addressable_shards)

        # a collective crossing the process boundary, checked exactly:
        # psum of a per-device one over the whole 8-device cluster
        from jax import shard_map
        ones = jax.make_array_from_callback(
            (8,), NamedSharding(mesh, P(("data", "time"))),
            lambda idx: np.ones(1, np.float32))
        total = jax.jit(shard_map(
            lambda x: jax.lax.psum(jnp.sum(x), ("data", "time")),
            mesh=mesh, in_specs=P(("data", "time")), out_specs=P()))(ones)
        report["psum_total"] = float(np.asarray(
            total.addressable_shards[0].data))
        assert report["psum_total"] == 8.0

        report["ok"] = True
    except Exception:
        report["error"] = traceback.format_exc()
    finally:
        with open(args.out, "w") as f:
            json.dump(report, f)
    return 0 if report["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
