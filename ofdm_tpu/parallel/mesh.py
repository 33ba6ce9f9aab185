"""Device mesh construction for the distributed transceiver.

The reference is a single-radio CPU pipeline (SURVEY.md section 2.4); this
framework scales two ways:

- ``data`` axis: independent OFDM channels / frames / capture buffers —
  embarrassingly parallel, the primary scaling axis (north star: 64+ channels).
- ``time`` axis: sequence parallelism over long sample streams.  Sliding
  correlation windows need a 79-sample halo from the right neighbor
  (locking template is 80 long), exchanged with ``ppermute``.

The GPUs of one host are joined all to all by NVLink, so every device pair
is equally close and the mesh's shape follows the algorithm alone; XLA
hands the collectives to NCCL.  `make_mesh` takes the device order from
``mesh_utils.create_device_mesh``.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.experimental import mesh_utils
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

DATA_AXIS = "data"
TIME_AXIS = "time"


def make_mesh(n_data: int | None = None, n_time: int = 1,
              devices=None) -> Mesh:
    """Mesh over available devices with ("data", "time") axes.

    Defaults to all devices on the data axis.
    """
    devices = devices if devices is not None else jax.devices()
    n_total = len(devices)
    if n_data is None:
        n_data = n_total // n_time
    assert n_data * n_time <= n_total, (
        f"mesh {n_data}x{n_time} exceeds {n_total} devices")
    try:
        dev_array = mesh_utils.create_device_mesh(
            (n_data, n_time), devices=devices[: n_data * n_time])
    except Exception:
        dev_array = np.asarray(devices[: n_data * n_time]).reshape(n_data, n_time)
    return Mesh(dev_array, (DATA_AXIS, TIME_AXIS))


def data_sharding(mesh: Mesh) -> NamedSharding:
    """Batch-of-channels sharding: rows over the data axis."""
    return NamedSharding(mesh, P(DATA_AXIS))


def time_sharding(mesh: Mesh) -> NamedSharding:
    """Sample-stream sharding: [B, T] with T over the time axis."""
    return NamedSharding(mesh, P(DATA_AXIS, TIME_AXIS))
