"""Distributed transceiver pipelines over a ("data", "time") mesh.

Three building blocks:

- ``sharded_sync_offset`` — sequence-parallel frame sync: the sample stream's
  time axis is sharded, each shard runs the sliding correlation locally after
  a 79-sample ring halo exchange (ppermute), and a distributed
  argmax with first-occurrence tie-breaking reproduces the reference offset
  (src/receiver.rs:20-25) for all non-negative lags.
- ``decode_frame_sharded`` — channel/data-parallel batched decode: rows of
  the batch shard over the data axis; XLA partitions the whole rx chain with
  zero cross-device communication.
- ``pipeline_step`` — the full tx -> channel -> rx -> BER step used for
  multi-chip validation and scaling benchmarks; bit errors are psum-reduced
  across the mesh (the framework's "training step" analog).
"""

from __future__ import annotations

from functools import lru_cache, partial

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import NamedSharding, PartitionSpec as P

from .. import constants
from ..config import DEFAULT_CONFIG, FrameConfig
from ..phy import rx as rx_mod
from ..phy.modulation import Modulation
from ..phy.tx import encode_payload, n_data_blocks
from .halo import global_argmax
from .mesh import DATA_AXIS, TIME_AXIS


def sharded_sync_offset(samples: jnp.ndarray, mesh,
                        cfg: FrameConfig = DEFAULT_CONFIG) -> jnp.ndarray:
    """[B, T] (T divisible by mesh time size) -> offsets[B].

    Covers lags >= 0 (negative lags can only win on pathological streams; the
    host path handles the clean-signal lag-0 / offset=-1 case by clamping).
    """
    # numpy template (device-array closure constants d2h at lowering time)
    tdtype = np.complex64 if samples.dtype == jnp.complex64 else np.complex128
    template = constants.locking_for(cfg).astype(tdtype)
    k = cfg.sym_len
    n_time = mesh.shape[TIME_AXIS]

    def local_fn(shard):
        # shard: [B_loc, T_loc].  Halo: first k-1 samples of right neighbor;
        # the last shard zeroes its (wrapped) halo so no spurious windows.
        my_t = jax.lax.axis_index(TIME_AXIS)
        head = shard[:, : k - 1]
        perm = [(i, (i - 1) % n_time) for i in range(n_time)]
        recv = jax.lax.ppermute(head, TIME_AXIS, perm)
        recv = jnp.where(my_t == n_time - 1, jnp.zeros_like(recv), recv)
        ext = jnp.concatenate([shard, recv], axis=-1)

        from ..ops.xcorr import sliding_correlation
        c = sliding_correlation(ext, template)
        # sliding_correlation output index i = lag i-(k-1) relative to ext;
        # keep exactly the T_loc windows starting inside this shard.
        c = c[:, k - 1: k - 1 + shard.shape[-1]]
        power = jnp.real(c) ** 2 + jnp.imag(c) ** 2
        idx = global_argmax(power, TIME_AXIS)          # [B_loc] global lag
        return (idx - 1).astype(jnp.int32)             # reference offset = lag-1

    fn = shard_map(local_fn, mesh=mesh,
                   in_specs=P(DATA_AXIS, TIME_AXIS),
                   out_specs=P(DATA_AXIS))
    return fn(samples)


def _rows_sharded(decode, x, mesh):
    """Run a row-wise ``decode`` per data shard under shard_map.

    Rows are independent, so each device decodes its own rows with no
    cross-device traffic.  The explicit shard_map (rather than GSPMD
    partitioning of a sharded argument) also keeps a Pallas kernel on the
    decode path local to each device, since a pallas_call has no GSPMD
    partitioning rule."""
    spec = P(DATA_AXIS, *([None] * (x.ndim - 1)))
    sharded = jax.device_put(x, NamedSharding(mesh, spec))
    fn = shard_map(decode, mesh=mesh, in_specs=(spec,),
                   out_specs=P(DATA_AXIS, None), check_vma=False)
    return fn(sharded)


def decode_frame_sharded(samples: jnp.ndarray, mesh, *, n_blocks: int,
                         guard_bands: bool = False,
                         modulation: Modulation = Modulation.BPSK,
                         cfg: FrameConfig = DEFAULT_CONFIG) -> jnp.ndarray:
    """Data-parallel batched decode: [B, T] rows sharded over the data axis."""
    return _rows_sharded(
        partial(rx_mod.decode_frame, n_blocks=n_blocks,
                guard_bands=guard_bands, modulation=modulation, cfg=cfg),
        samples, mesh)


def decode_frame_planar_sharded(planes: jnp.ndarray, mesh, *, n_blocks: int,
                                guard_bands: bool = False,
                                modulation: Modulation = Modulation.BPSK,
                                cfg: FrameConfig = DEFAULT_CONFIG
                                ) -> jnp.ndarray:
    """Data-parallel PLANAR batched decode: f32[B, 2, T] (or pre-tiled
    f32[B, 2, tiles, 128]) rows sharded over the data axis."""
    return _rows_sharded(
        partial(rx_mod.decode_frame_planar, n_blocks=n_blocks,
                guard_bands=guard_bands, modulation=modulation, cfg=cfg),
        planes, mesh)


@lru_cache(maxsize=None)
def _extract_rows(mesh, need: int, spacing: int, flen: int, n_rows: int,
                  cfg: FrameConfig):
    """Cached sharded frame-window extractor: repeated streaming calls at one
    deployment shape must hit the jit cache, not retrace (Mesh and cfg are
    both hashable, so the jit is memoized per configuration)."""
    @partial(jax.jit,
             out_shardings=NamedSharding(mesh, P(DATA_AXIS, None)))
    def _extract(s, first):
        # one contiguous slice + reshape (see phy.streaming._extract_and_decode)
        s = jnp.pad(s, (0, max(0, need - s.shape[-1]) + cfg.sym_len))
        return jax.lax.dynamic_slice_in_dim(
            s, first, n_rows * spacing).reshape(n_rows, spacing)[:, :flen]
    return _extract


def decode_regular_sharded(samples, mesh, *, n_frames: int, spacing: int,
                           payload_len: int, guard_bands: bool = True,
                           modulation: Modulation = Modulation.QPSK,
                           fec: str | None = None, data_len: int | None = None,
                           cfg: FrameConfig = DEFAULT_CONFIG):
    """Multi-frame streaming decode distributed over the mesh.

    The distributed counterpart of ``phy.streaming.decode_regular`` (the
    reference's live loop decodes one frame per capture buffer on one core —
    examples/jetson_rx.rs:83-113; here every frame of the stream decodes in
    parallel across the mesh): one global sync resolves the first frame
    start, the frame windows are extracted into rows laid out over the
    ``data`` axis, and the batched rx chain runs with zero cross-device
    communication.  FEC (Hamming on-device / RS host-side) composes on the
    gathered payloads exactly as in the single-device path.

    Returns (payloads [n_frames, data_len or payload_len], ok flags).
    """
    from ..phy import streaming as _s

    nb = n_data_blocks(payload_len, modulation, guard_bands, cfg)
    flen = cfg.sync_len + nb * cfg.sym_len
    assert spacing >= flen, f"spacing {spacing} < frame length {flen}"
    n_dev = mesh.shape[DATA_AXIS]
    n_rows = -(-n_frames // n_dev) * n_dev        # pad rows to the data axis
    need = n_rows * spacing + cfg.sym_len

    # device-resident sync result: no blocking d2h between the dispatches
    # (see phy.streaming.decode_regular)
    first = jnp.maximum(_s._first_sync(samples, spacing=spacing, need=need,
                                       cfg=cfg), 0).astype(jnp.int32)
    rows = _extract_rows(mesh, need, spacing, flen, n_rows, cfg)(
        samples, first)
    out = _rows_sharded(
        partial(rx_mod.decode_frame, n_blocks=nb, guard_bands=guard_bands,
                modulation=modulation, cfg=cfg, search_window=cfg.sym_len),
        rows, mesh)
    from ..packets.header import HEADER_LEN
    if fec == "hamming":
        # on-device FEC while still sharded over the data axis: the bit-matmul
        # decode is row-wise independent, so no resharding happens and only
        # the corrected user bytes are gathered to host
        n_bytes = data_len if data_len is not None else payload_len
        dec = _s._defec_hamming_device(out, payload_len=payload_len,
                                       n_bytes=n_bytes)
        return np.asarray(dec)[:n_frames], np.ones(n_frames, bool)
    raw = np.asarray(out)[:n_frames, HEADER_LEN:HEADER_LEN + payload_len]
    return _s._defec_rows(raw, fec, data_len if data_len is not None
                          else payload_len)


@lru_cache(maxsize=None)
def _scan_windows_sharded(mesh, n_win: int, stride: int, cfg: FrameConfig):
    """Sharded burst frame scan: the [n_win, stride+sym-1] window matrix lays
    over the data axis; the (small, replicated) stream gathers locally on
    each device — no cross-device traffic beyond the final offs/rho rows."""
    from ..phy import streaming as _s
    out_shard = NamedSharding(mesh, P(DATA_AXIS))

    @partial(jax.jit, out_shardings=(out_shard, out_shard))
    def fn(s):
        return _s._scan_windows.__wrapped__(s, n_win=n_win, stride=stride,
                                            cfg=cfg)
    return fn


@lru_cache(maxsize=None)
def _decode_at_positions_sharded(mesh, n_rows: int, nb: int, flen: int,
                                 guard_bands: bool, modulation: Modulation,
                                 cfg: FrameConfig):
    from ..phy import streaming as _s

    @partial(jax.jit,
             in_shardings=(None, NamedSharding(mesh, P(DATA_AXIS))),
             out_shardings=NamedSharding(mesh, P(DATA_AXIS, None)))
    def fn(s, pos):
        return _s._decode_at_positions.__wrapped__(
            s, pos, n_rows=n_rows, nb=nb, flen=flen, guard_bands=guard_bands,
            modulation=modulation, cfg=cfg)
    return fn


def decode_burst_sharded(samples, mesh, *, payload_len: int,
                         guard_bands: bool = True,
                         modulation: Modulation = Modulation.QPSK,
                         fec: str | None = None, data_len: int | None = None,
                         acquisition: int = 4096,
                         max_frames: int | None = None,
                         detection_rho: float = 0.3,
                         cfg: FrameConfig = DEFAULT_CONFIG) -> list[tuple]:
    """Distributed ``phy.streaming.decode_burst``: both batched dispatches
    (the whole-stream frame scan and the detected-frame decode) shard their
    row axes over the mesh's data axis; the host gate/NMS between them is
    unchanged (examples/jetson_rx.rs:83-113 is the workload being scaled).

    Returns [(position, payload, ok), ...] sorted by position — identical to
    the single-device path (tests/test_parallel.py locks the equivalence).
    """
    from ..phy import streaming as _s

    samples = jnp.asarray(samples)
    nb = n_data_blocks(payload_len, modulation, guard_bands, cfg)
    flen = cfg.sync_len + nb * cfg.sym_len
    n_out = data_len if data_len is not None else payload_len
    t = samples.shape[-1]
    if t < flen:
        return []
    n_dev = mesh.shape[DATA_AXIS]
    stride = min(acquisition, flen)
    n_win = max(1, -(-(t - flen + 1) // stride))
    n_win = -(-n_win // n_dev) * n_dev      # pad rows to the data axis; the
    # extra windows scan zero padding and score rho ~ 0, below any gate

    offs, pars = _scan_windows_sharded(mesh, n_win, stride, cfg)(samples)
    detections = _s._gate_detections(
        np.asarray(offs), np.asarray(pars), t=t, stride=stride, flen=flen,
        detection_rho=detection_rho, max_frames=max_frames, cfg=cfg)
    if not detections:
        return []

    n_rows = 1 << (len(detections) - 1).bit_length()   # power-of-two bucket
    n_rows = -(-n_rows // n_dev) * n_dev               # and data-axis padded
    pos = np.asarray(
        detections + [detections[-1]] * (n_rows - len(detections)), np.int32)
    out = np.asarray(_decode_at_positions_sharded(
        mesh, n_rows, nb, flen, guard_bands, modulation, cfg)(
            samples, jnp.asarray(pos)))

    from ..packets.header import HEADER_LEN
    raw = out[:len(detections), HEADER_LEN:HEADER_LEN + payload_len]
    payloads, oks = _s._defec_rows(raw, fec, n_out)
    return [(p, payloads[i], bool(oks[i]))
            for i, p in enumerate(detections)]


def make_pipeline_step(mesh, *, payload_len: int, guard_bands: bool = True,
                       modulation: Modulation = Modulation.QAM64,
                       snr: float = 45.0, timing_error: bool = True,
                       cfg: FrameConfig = DEFAULT_CONFIG):
    """Build the jitted full-pipeline step over the mesh.

    Returns step(payload[B, L], key) -> (decoded[B, n_bytes], total_bit_errors)
    with the batch sharded over the data axis and sync executed
    sequence-parallel over the time axis.
    """
    nb = n_data_blocks(payload_len, modulation, guard_bands, cfg)
    n_chunks = cfg.n_sync_chunks + nb
    frame = n_chunks * cfg.sym_len
    n_time = mesh.shape[TIME_AXIS]

    data_shard = NamedSharding(mesh, P(DATA_AXIS))

    import numpy as np

    from ..packets.header import Header
    from .timeshard import channel_timesharded_fn, timesharded_decode_fn
    header = jnp.asarray(np.frombuffer(Header(payload_len).to_bytes(), np.uint8))
    decode_ts = timesharded_decode_fn(mesh, n_blocks=nb,
                                      guard_bands=guard_bands,
                                      modulation=modulation, cfg=cfg)
    channel_ts = channel_timesharded_fn(mesh, snr=snr,
                                        timing_error=timing_error, cfg=cfg)

    @partial(jax.jit,
             in_shardings=(NamedSharding(mesh, P(DATA_AXIS, None)), None),
             out_shardings=(data_shard, None))
    def step(data, key):
        hdr = jnp.broadcast_to(header, (*data.shape[:-1], header.shape[0]))
        payload = jnp.concatenate([hdr, data], axis=-1)
        tx = encode_payload(payload, guard_bands=guard_bands,
                            modulation=modulation, cfg=cfg)
        # pad the time axis to a multiple of the time mesh; the slack also
        # holds the conv smear (63 samples) and the sync-offset clamp window
        need = frame + cfg.sym_len
        t_pad = -(tx.shape[-1] + need) % (n_time * cfg.sym_len) + need
        tx = jnp.pad(tx, ((0, 0), (0, t_pad)))
        # Pin the ENCODE harness to the data axis (rows replicated along
        # time): left to itself GSPMD splits the per-block IFFT matmuls over
        # time and pays resharding collectives — exactly the comm profile
        # the pipeline must not have (test_no_time_axis_allgather).
        # Replicated-along-time -> P(data, time) into the shard_maps is a
        # local slice, free.
        tx = jax.lax.with_sharding_constraint(
            tx, NamedSharding(mesh, P(DATA_AXIS, None)))
        # sequence-parallel END TO END: the channel simulator convolves with
        # a 63-sample left-halo ppermute + psum'd noise variance, and decode
        # runs sync/symbol-spill/demod per shard — only halos, the
        # 800-sample sync chunks, decoded bytes and scalars ever cross the
        # time axis (parallel/timeshard.py)
        rx = channel_ts(tx, key)
        decoded = decode_ts(rx)
        from ..obs.analysis import bit_errors
        errs = bit_errors(decoded[:, cfg.header_len_bytes:
                                  cfg.header_len_bytes + payload_len], data)
        return decoded, jnp.sum(errs)

    return step
