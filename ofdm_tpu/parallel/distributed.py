"""Multi-host runtime initialization.

One JAX distributed runtime spans all processes of a job: the GPUs of one
host reach each other all to all over NVLink, and hosts talk over the
network; XLA hands the collectives to NCCL (SURVEY.md section 2.4).  This
wrapper makes the single-process case a no-op so apps and benches run
unchanged from one GPU to many hosts.

Usage (one call at process start, before any backend use):

    from ofdm_tpu.parallel.distributed import initialize
    initialize()                       # env-driven (cluster schedulers)
    initialize(coordinator="host0:1234", num_processes=4, process_id=i)

Exercised for real (two OS processes on localhost, gloo CPU collectives,
full sequence-parallel pipeline step over a global 4x2 mesh with byte
parity) by tests/test_distributed.py + tools/dist_worker.py.
"""

from __future__ import annotations

import logging

log = logging.getLogger("ofdm_tpu.distributed")


def initialize(coordinator: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None) -> bool:
    """Initialize jax.distributed when running multi-process; returns True
    if a distributed runtime was started."""
    import jax

    if num_processes is None and coordinator is None:
        # a cluster scheduler (e.g. SLURM) populates the environment;
        # elsewhere single-process.
        try:
            jax.distributed.initialize()
            started = jax.process_count() > 1
        except Exception as e:  # single-process / no cluster env
            log.debug("distributed init skipped: %s", e)
            return False
        if started:
            log.info("distributed runtime: process %d/%d, %d global devices",
                     jax.process_index(), jax.process_count(),
                     len(jax.devices()))
        return started

    jax.distributed.initialize(coordinator_address=coordinator,
                               num_processes=num_processes,
                               process_id=process_id)
    log.info("distributed runtime: process %d/%d", jax.process_index(),
             jax.process_count())
    return True


def global_mesh(n_time: int = 1):
    """Mesh over all global devices (all hosts), data-major."""
    from .mesh import make_mesh

    import jax

    return make_mesh(n_data=len(jax.devices()) // n_time, n_time=n_time)
