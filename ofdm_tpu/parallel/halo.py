"""Ring halo exchange over the time axis (sequence parallelism).

The receiver's sliding correlation needs each time-shard to see the first
K-1 samples of its right neighbor (K = 80-sample locking template), and the
symbol chunking needs whole 80-sample symbols after sync alignment.  Both are
served by a right-to-left halo exchange: shard i receives the leading ``halo``
samples of shard i+1, via ``jax.lax.ppermute`` around the mesh's time-axis
ring (SURVEY.md section 5.7).

Everything here runs inside ``shard_map`` — per-shard code with explicit
collectives, the batched replacement for the reference's single sequential
``Vec`` scan (src/receiver.rs:36-74).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from .mesh import TIME_AXIS


def right_halo(local: jnp.ndarray, halo: int, axis_name: str = TIME_AXIS) -> jnp.ndarray:
    """Append the first ``halo`` samples of the right neighbor's shard.

    local: [..., T_local] -> [..., T_local + halo].  The last shard in the
    ring receives the *first* shard's head (circular); callers mask it out or
    rely on it being past any valid correlation peak.
    """
    n = jax.lax.axis_size(axis_name)
    head = local[..., :halo]
    # send my head to my LEFT neighbor == receive right neighbor's head
    perm = [(i, (i - 1) % n) for i in range(n)]
    recv = jax.lax.ppermute(head, axis_name, perm)
    return jnp.concatenate([local, recv], axis=-1)


def global_argmax(power: jnp.ndarray, axis_name: str = TIME_AXIS):
    """Distributed argmax over time shards.

    power: [..., T_local] (already halo-trimmed so windows aren't double
    counted).  Returns the global flat index [...] of the max across the
    sharded last axis, with first-occurrence (lowest index) tie-breaking to
    match the reference argmax (src/signals/mod.rs:205-214).
    """
    t_local = power.shape[-1]
    my_idx = jax.lax.axis_index(axis_name)
    local_arg = jnp.argmax(power, axis=-1)
    local_max = jnp.max(power, axis=-1)
    global_max = jax.lax.pmax(local_max, axis_name)
    # candidate global index; non-winning shards submit +inf-like sentinel
    cand = my_idx * t_local + local_arg
    cand = jnp.where(local_max == global_max, cand, jnp.iinfo(jnp.int32).max)
    return jax.lax.pmin(cand.astype(jnp.int32), axis_name)
