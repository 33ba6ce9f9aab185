"""Time-sharded full-chain decode == single-device decode, byte for byte.

The sequence-parallel receiver (parallel/timeshard.py) must reproduce
``decode_frame`` exactly for frame offsets anywhere in the stream — in
particular offsets that straddle time-shard boundaries, where the
symbol-boundary halo spill and the one-hot chunk scatter do the work.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import ofdm_tpu as ot
from ofdm_tpu.parallel.mesh import make_mesh
from ofdm_tpu.parallel.timeshard import decode_frame_timesharded

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8,
                                reason="needs 8 fake devices")


@pytest.fixture(scope="module")
def rng():
    return np.random.default_rng(7)


def _frame(rng, payload_len, modulation, guard_bands, snr=None, key=0):
    data = rng.integers(0, 256, payload_len, dtype=np.uint8)
    tx = np.asarray(ot.encode(data, guard_bands=guard_bands,
                              modulation=modulation, dtype=jnp.complex128))
    if snr is not None:
        tx = np.asarray(ot.channel(jnp.asarray(tx), snr=snr,
                                   key=jax.random.key(key)))
    return data, tx


def _stream_with_frames(rng, tx, offsets, T):
    """[len(offsets), T] noise-floor streams, frame embedded at offsets[i]."""
    s = 0.003 * (rng.standard_normal((len(offsets), T))
                 + 1j * rng.standard_normal((len(offsets), T)))
    for i, off in enumerate(offsets):
        s[i, off:off + tx.shape[-1]] += tx
    return jnp.asarray(s)


# mesh (1, 8): T_loc = 640 — offsets probe shard interiors, boundaries, and
# the frame spanning 3+ shards
BOUNDARY_OFFSETS = [0, 1, 79, 80, 639, 640, 641, 1000, 1279, 1281, 2555, 3600]


def test_timesharded_matches_decode_frame_boundary_offsets(rng):
    mesh = make_mesh(n_data=1, n_time=8)
    payload_len = 90
    data, tx = _frame(rng, payload_len, ot.Modulation.QPSK, True)
    nb = ot.n_data_blocks(payload_len, ot.Modulation.QPSK, True)
    T = 5120                                   # 8 shards x 640 (8 symbols each)
    for group in (BOUNDARY_OFFSETS[:6], BOUNDARY_OFFSETS[6:]):
        stream = _stream_with_frames(rng, tx, group, T)
        ts = np.asarray(decode_frame_timesharded(
            stream, mesh, n_blocks=nb, guard_bands=True,
            modulation=ot.Modulation.QPSK))
        ref = np.asarray(ot.decode_frame(stream, n_blocks=nb,
                                         guard_bands=True,
                                         modulation=ot.Modulation.QPSK))
        np.testing.assert_array_equal(ts, ref)
        np.testing.assert_array_equal(
            ts[:, 16:16 + payload_len], np.tile(data, (len(group), 1)))


def test_timesharded_derot_matrix_parity(rng):
    """derot_impl="matrix" on the time-sharded path (CFO folded into the
    per-shard DFT matrix) must stay byte-identical to decode_frame across
    shard-straddling offsets, including a real channel CFO draw."""
    mesh = make_mesh(n_data=1, n_time=8)
    payload_len = 90
    data, tx = _frame(rng, payload_len, ot.Modulation.QAM16, True,
                      snr=35.0, key=11)
    nb = ot.n_data_blocks(payload_len, ot.Modulation.QAM16, True)
    T = 5760
    stream = _stream_with_frames(rng, tx, [0, 639, 641, 1281], T)
    ts = np.asarray(decode_frame_timesharded(
        stream, mesh, n_blocks=nb, guard_bands=True,
        modulation=ot.Modulation.QAM16, derot_impl="matrix"))
    ref = np.asarray(ot.decode_frame(stream, n_blocks=nb, guard_bands=True,
                                     modulation=ot.Modulation.QAM16))
    np.testing.assert_array_equal(ts, ref)
    np.testing.assert_array_equal(ts[:, 16:16 + payload_len],
                                  np.tile(data, (4, 1)))


def test_timesharded_derot_matrix_parity_no_guard_bands(rng):
    """The guard_bands=False arm of the timeshard matrix-derot branch
    (sel_all spans all n_fft bins, replacing the stream branch's fft())."""
    mesh = make_mesh(n_data=1, n_time=8)
    payload_len = 90
    data, tx = _frame(rng, payload_len, ot.Modulation.QPSK, False,
                      snr=35.0, key=13)
    nb = ot.n_data_blocks(payload_len, ot.Modulation.QPSK, False)
    T = 5760
    stream = _stream_with_frames(rng, tx, [0, 639, 641, 1281], T)
    ts = np.asarray(decode_frame_timesharded(
        stream, mesh, n_blocks=nb, guard_bands=False,
        modulation=ot.Modulation.QPSK, derot_impl="matrix"))
    ref = np.asarray(ot.decode_frame(stream, n_blocks=nb, guard_bands=False,
                                     modulation=ot.Modulation.QPSK))
    np.testing.assert_array_equal(ts, ref)
    np.testing.assert_array_equal(ts[:, 16:16 + payload_len],
                                  np.tile(data, (4, 1)))


@pytest.mark.parametrize("n_data,n_time", [(2, 4), (4, 2)])
def test_timesharded_mixed_mesh_with_channel(rng, n_data, n_time):
    """Multipath + CFO + noise through the simulated channel, mixed meshes."""
    mesh = make_mesh(n_data=n_data, n_time=n_time)
    payload_len = 60
    data, tx = _frame(rng, payload_len, ot.Modulation.QPSK, True,
                      snr=30.0, key=2)
    nb = ot.n_data_blocks(payload_len, ot.Modulation.QPSK, True)
    offsets = [0, 315, 963, 1280][:max(n_data, 4)]
    T = 4 * n_time * 80 * 8                    # multiple of every shard quant
    stream = _stream_with_frames(rng, tx, offsets, T)
    ts = np.asarray(decode_frame_timesharded(
        stream, mesh, n_blocks=nb, guard_bands=True,
        modulation=ot.Modulation.QPSK))
    ref = np.asarray(ot.decode_frame(stream, n_blocks=nb, guard_bands=True,
                                     modulation=ot.Modulation.QPSK))
    np.testing.assert_array_equal(ts, ref)
    np.testing.assert_array_equal(ts[:, 16:16 + payload_len],
                                  np.tile(data, (len(offsets), 1)))


def test_timesharded_qam64_no_guard_bands(rng):
    """The no-guard-band path (full 64-bin DFT, no pilot phase)."""
    mesh = make_mesh(n_data=1, n_time=8)
    payload_len = 64
    data, tx = _frame(rng, payload_len, ot.Modulation.QAM64, False,
                      snr=45.0, key=3)
    nb = ot.n_data_blocks(payload_len, ot.Modulation.QAM64, False)
    stream = _stream_with_frames(rng, tx, [777, 1601], 3840)
    ts = np.asarray(decode_frame_timesharded(
        stream, mesh, n_blocks=nb, guard_bands=False,
        modulation=ot.Modulation.QAM64))
    ref = np.asarray(ot.decode_frame(stream, n_blocks=nb, guard_bands=False,
                                     modulation=ot.Modulation.QAM64))
    np.testing.assert_array_equal(ts, ref)


def test_timesharded_hamming_fec_tail(rng):
    """fec="hamming" on the time axis: byte-identical to decode_frame + the
    SoA Hamming tail, and recovers the user bytes exactly (BASELINE config 4
    riding sequence parallelism)."""
    from ofdm_tpu.fec import hamming
    from ofdm_tpu.phy.streaming import coded_len

    mesh = make_mesh(n_data=1, n_time=8)
    data_len = 64
    payload_len = coded_len(data_len, "hamming")
    user = rng.integers(0, 256, (3, data_len), dtype=np.uint8)
    frames = np.asarray(ot.encode_hamming(jnp.asarray(user), guard_bands=True,
                                          modulation=ot.Modulation.QPSK,
                                          dtype=jnp.complex128))
    nb = ot.n_data_blocks(payload_len, ot.Modulation.QPSK, True)
    offsets = [0, 641, 2555]
    T = 5760
    stream = np.zeros((3, T), np.complex128)
    for i, off in enumerate(offsets):
        stream[i, off:off + frames.shape[-1]] = frames[i]
    stream = jnp.asarray(stream)
    ts = np.asarray(decode_frame_timesharded(
        stream, mesh, n_blocks=nb, guard_bands=True,
        modulation=ot.Modulation.QPSK, fec="hamming",
        payload_len=payload_len, data_len=data_len))
    ref_raw = np.asarray(ot.decode_frame(stream, n_blocks=nb,
                                         guard_bands=True,
                                         modulation=ot.Modulation.QPSK))
    ref = np.asarray(hamming.decode(
        jnp.asarray(ref_raw[:, 16:16 + payload_len]), data_len))
    np.testing.assert_array_equal(ts, ref)
    np.testing.assert_array_equal(ts, user)


def test_timesharded_search_window(rng):
    """search_window bounds the distributed sync acquisition: a louder decoy
    frame beyond the window must not steal the argmax; in-window result is
    byte-identical to decode_frame with the same window."""
    mesh = make_mesh(n_data=1, n_time=8)
    payload_len = 90
    data, tx = _frame(rng, payload_len, ot.Modulation.QPSK, True)
    data2, tx2 = _frame(rng, payload_len, ot.Modulation.QPSK, True)
    nb = ot.n_data_blocks(payload_len, ot.Modulation.QPSK, True)
    T = 5120
    stream = np.zeros((2, T), np.complex128)
    for i, off in enumerate([37, 100]):
        stream[i, off:off + tx.shape[-1]] = tx
        decoy = 2600 + i                  # louder frame w/ DIFFERENT payload
        stream[i, decoy:decoy + tx2.shape[-1]] += 1.5 * tx2
    stream = jnp.asarray(stream)
    w = 256
    ts = np.asarray(decode_frame_timesharded(
        stream, mesh, n_blocks=nb, guard_bands=True,
        modulation=ot.Modulation.QPSK, search_window=w))
    ref = np.asarray(ot.decode_frame(stream, n_blocks=nb, guard_bands=True,
                                     modulation=ot.Modulation.QPSK,
                                     search_window=w))
    np.testing.assert_array_equal(ts, ref)
    np.testing.assert_array_equal(ts[:, 16:16 + payload_len],
                                  np.tile(data, (2, 1)))
    # sanity: without the window the decoy wins (different bytes)
    ts_full = np.asarray(decode_frame_timesharded(
        stream, mesh, n_blocks=nb, guard_bands=True,
        modulation=ot.Modulation.QPSK))
    assert not np.array_equal(ts_full, ts)


def test_channel_timesharded_conv_matches(rng):
    """Noise/CFO off: the halo-convolved sharded channel equals the
    single-device linear convolution sample for sample (the overlap region
    at every shard boundary is exercised by a signal longer than 3 shards)."""
    from ofdm_tpu import constants
    from ofdm_tpu.parallel.timeshard import channel_timesharded_fn

    mesh = make_mesh(n_data=2, n_time=4)
    T = 4 * 640
    xs = rng.standard_normal((4, T)) + 1j * rng.standard_normal((4, T))
    fn = jax.jit(channel_timesharded_fn(mesh, snr=None, timing_error=False))
    sharding = jax.sharding.NamedSharding(
        mesh, jax.sharding.PartitionSpec("data", "time"))
    got = np.asarray(fn(jax.device_put(jnp.asarray(xs), sharding),
                        jax.random.key(0)))
    # single-device reference: full linear conv, first T samples
    ref = np.stack([np.convolve(xs[i], constants.CHANNEL_TAPS)[:T]
                    for i in range(4)])
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-12)


def test_pipeline_with_sharded_channel_zero_errors(rng):
    """End-to-end sequence-parallel pipeline (sharded channel AND decode)
    still decodes error-free with CFO + noise at SNR 30."""
    from ofdm_tpu.parallel.pipeline import make_pipeline_step
    mesh = make_mesh(n_data=2, n_time=4)
    step = make_pipeline_step(mesh, payload_len=64, guard_bands=True,
                              modulation=ot.Modulation.QPSK, snr=30.0,
                              timing_error=True)
    data = jnp.asarray(rng.integers(0, 256, (8, 64), dtype=np.uint8))
    decoded, errs = step(data, jax.random.key(5))
    assert int(errs) == 0
    np.testing.assert_array_equal(np.asarray(decoded)[:, 16:80],
                                  np.asarray(data))


def test_timesharded_no_retrace(rng):
    """Streaming calls at one deployment shape reuse the cached jit."""
    from ofdm_tpu.parallel.timeshard import _jitted
    mesh = make_mesh(n_data=1, n_time=8)
    payload_len = 90
    data, tx = _frame(rng, payload_len, ot.Modulation.QPSK, True)
    nb = ot.n_data_blocks(payload_len, ot.Modulation.QPSK, True)
    stream = _stream_with_frames(rng, tx, [500], 5120)
    _ = decode_frame_timesharded(stream, mesh, n_blocks=nb, guard_bands=True,
                                 modulation=ot.Modulation.QPSK)
    size = _jitted.cache_info().currsize
    out = decode_frame_timesharded(stream + 0, mesh, n_blocks=nb,
                                   guard_bands=True,
                                   modulation=ot.Modulation.QPSK)
    assert _jitted.cache_info().currsize == size
    np.testing.assert_array_equal(np.asarray(out)[0, 16:16 + payload_len],
                                  data)
