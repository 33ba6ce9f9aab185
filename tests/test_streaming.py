"""Continuous multi-frame stream demod tests (BASELINE config 4)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import ofdm_tpu as ot
from ofdm_tpu.fec import hamming
from ofdm_tpu.phy.streaming import coded_len, decode_continuous, decode_regular


@pytest.fixture(scope="module")
def frames():
    """4 Hamming-coded frames with distinct payloads."""
    rng = np.random.default_rng(0)
    datas = [rng.integers(0, 256, 96, dtype=np.uint8) for _ in range(4)]
    coded = np.stack([np.asarray(hamming.encode(jnp.asarray(d))) for d in datas])
    tx = np.asarray(ot.encode(coded, guard_bands=True,
                              modulation=ot.Modulation.QPSK,
                              dtype=jnp.complex128))
    return datas, tx


def test_coded_len():
    assert coded_len(96, None) == 96
    assert coded_len(96, "hamming") == hamming.encoded_len(96) == 168
    assert coded_len(96, "rs") == 255


def test_decode_regular_back_to_back(frames):
    datas, tx = frames
    spacing = tx.shape[1]
    stream = jnp.asarray(tx.reshape(-1))  # frames back-to-back
    payloads, oks = decode_regular(
        stream, n_frames=4, spacing=spacing, payload_len=coded_len(96, "hamming"),
        modulation=ot.Modulation.QPSK, fec="hamming", data_len=96)
    assert oks.all()
    for i in range(4):
        np.testing.assert_array_equal(payloads[i], datas[i])


def test_decode_regular_through_channel(frames):
    datas, tx = frames
    spacing = tx.shape[1] + 200
    stream = np.zeros(4 * spacing + 100, np.complex128)
    for i in range(4):
        stream[i * spacing: i * spacing + tx.shape[1]] = tx[i]
    noisy = ot.channel(jnp.asarray(stream), snr=20.0, key=jax.random.key(2))
    payloads, oks = decode_regular(
        noisy, n_frames=4, spacing=spacing, payload_len=coded_len(96, "hamming"),
        modulation=ot.Modulation.QPSK, fec="hamming", data_len=96)
    assert oks.all()
    for i in range(4):
        np.testing.assert_array_equal(payloads[i], datas[i])


def test_decode_continuous_irregular_gaps(frames):
    datas, tx = frames
    rng = np.random.default_rng(5)
    gaps = [700, 1500, 300, 2200]
    parts = []
    positions = []
    pos = 0
    for i in range(4):
        noise = 0.001 * (rng.standard_normal(gaps[i])
                         + 1j * rng.standard_normal(gaps[i]))
        parts.append(noise)
        pos += gaps[i]
        positions.append(pos)
        parts.append(tx[i])
        pos += tx.shape[1]
    stream = np.concatenate(parts)

    results = list(decode_continuous(
        jnp.asarray(stream), payload_len=coded_len(96, "hamming"),
        modulation=ot.Modulation.QPSK, fec="hamming", data_len=96,
        acquisition=4096))
    assert len(results) == 4
    for i, (found_pos, payload, ok) in enumerate(results):
        assert ok
        assert abs(found_pos - positions[i]) <= 2
        np.testing.assert_array_equal(payload, datas[i])


def test_decode_continuous_max_frames(frames):
    _, tx = frames
    stream = jnp.asarray(tx.reshape(-1))
    results = list(decode_continuous(
        stream, payload_len=coded_len(96, "hamming"),
        modulation=ot.Modulation.QPSK, fec="hamming", data_len=96,
        max_frames=2))
    assert len(results) == 2


def test_no_retrace_across_calls(frames):
    """Streaming graphs are module-level jits: a server decoding one buffer
    per call must hit the jit cache, not retrace and recompile."""
    from ofdm_tpu.phy import streaming as st

    datas, tx = frames
    spacing = tx.shape[1]
    plen = coded_len(96, "hamming")
    stream = jnp.asarray(tx.reshape(-1))

    decode_regular(stream, n_frames=4, spacing=spacing, payload_len=plen,
                   modulation=ot.Modulation.QPSK, fec="hamming", data_len=96)
    sizes = (st._first_sync._cache_size(), st._extract_and_decode._cache_size())
    # second buffer, same deployment shape -> zero new traces
    decode_regular(stream + 0, n_frames=4, spacing=spacing, payload_len=plen,
                   modulation=ot.Modulation.QPSK, fec="hamming", data_len=96)
    assert (st._first_sync._cache_size(),
            st._extract_and_decode._cache_size()) == sizes

    list(decode_continuous(stream, payload_len=plen,
                           modulation=ot.Modulation.QPSK, fec="hamming",
                           data_len=96, acquisition=256))
    sizes = (st._scan_at._cache_size(), st._dec_at._cache_size())
    list(decode_continuous(stream + 0, payload_len=plen,
                           modulation=ot.Modulation.QPSK, fec="hamming",
                           data_len=96, acquisition=256))
    assert (st._scan_at._cache_size(), st._dec_at._cache_size()) == sizes


def test_decode_regular_presync_matches(frames):
    """resync=False (trust global sync + exact spacing) == resync=True."""
    datas, tx = frames
    spacing = tx.shape[1]
    stream = jnp.asarray(tx.reshape(-1))
    kw = dict(n_frames=4, spacing=spacing, payload_len=coded_len(96, "hamming"),
              modulation=ot.Modulation.QPSK, fec="hamming", data_len=96)
    p1, ok1 = decode_regular(stream, resync=True, **kw)
    p2, ok2 = decode_regular(stream, resync=False, **kw)
    np.testing.assert_array_equal(p1, p2)
    assert ok1.all() and ok2.all()
    for i in range(4):
        np.testing.assert_array_equal(p2[i], datas[i])


def test_decode_regular_presync_through_channel(frames):
    """presync survives a noisy delayed channel (global sync finds `first`)."""
    datas, tx = frames
    spacing = tx.shape[1]
    stream = np.zeros(4 * spacing + 300, np.complex128)
    for i in range(4):
        stream[123 + i * spacing: 123 + i * spacing + spacing] = tx[i]
    noisy = ot.channel(jnp.asarray(stream), snr=20.0, key=jax.random.key(9))
    p, ok = decode_regular(noisy, n_frames=4, spacing=spacing,
                           payload_len=coded_len(96, "hamming"),
                           modulation=ot.Modulation.QPSK, fec="hamming",
                           data_len=96, resync=False)
    assert ok.all()
    for i in range(4):
        np.testing.assert_array_equal(p[i], datas[i])


def test_decode_burst_matches_continuous(frames):
    """Two-dispatch batched burst decode == the host-driven scan loop."""
    from ofdm_tpu.phy.streaming import decode_burst

    datas, tx = frames
    rng = np.random.default_rng(5)
    gaps = [700, 1500, 300, 2200]
    parts, positions, pos = [], [], 0
    for i in range(4):
        noise = 0.001 * (rng.standard_normal(gaps[i])
                         + 1j * rng.standard_normal(gaps[i]))
        parts.append(noise)
        pos += gaps[i]
        positions.append(pos)
        parts.append(tx[i])
        pos += tx.shape[1]
    stream = jnp.asarray(np.concatenate(parts))

    kw = dict(payload_len=coded_len(96, "hamming"),
              modulation=ot.Modulation.QPSK, fec="hamming", data_len=96,
              acquisition=4096)
    burst = decode_burst(stream, **kw)
    cont = list(decode_continuous(stream, **kw))
    assert len(burst) == len(cont) == 4
    for i, ((bp, bd, bok), (cp, cd, cok)) in enumerate(zip(burst, cont)):
        assert bok and cok
        assert abs(bp - positions[i]) <= 2
        np.testing.assert_array_equal(bd, datas[i])
        np.testing.assert_array_equal(bd, cd)


def test_decode_burst_clean_positions(frames):
    """No channel, no noise: burst positions land exactly on frame starts
    and decode byte-exact (probes the sync offset convention directly)."""
    from ofdm_tpu.phy.streaming import decode_burst

    datas, tx = frames
    positions = [523, 523 + tx.shape[1] + 977]
    stream = np.zeros(positions[-1] + tx.shape[1] + 401, tx.dtype)
    for i, p in enumerate(positions):
        stream[p: p + tx.shape[1]] = tx[i]

    results = decode_burst(jnp.asarray(stream),
                           payload_len=coded_len(96, "hamming"),
                           modulation=ot.Modulation.QPSK, fec="hamming",
                           data_len=96, acquisition=2048)
    assert len(results) == 2
    for i, (p, d, ok) in enumerate(results):
        assert ok
        assert abs(p - positions[i]) <= 1
        np.testing.assert_array_equal(d, datas[i])


def test_decode_burst_empty_and_max(frames):
    from ofdm_tpu.phy.streaming import decode_burst

    _, tx = frames
    kw = dict(payload_len=coded_len(96, "hamming"),
              modulation=ot.Modulation.QPSK, fec="hamming", data_len=96)
    noise = 0.001 * np.random.default_rng(0).standard_normal(40000).astype(
        np.complex128)
    assert decode_burst(jnp.asarray(noise), **kw) == []
    stream = jnp.asarray(np.asarray(tx).reshape(-1))
    assert len(decode_burst(stream, max_frames=2, **kw)) == 2


def test_decode_burst_through_channel(frames):
    """Burst detection survives multipath + AWGN + CFO (rho gate holds)."""
    from ofdm_tpu.phy.streaming import decode_burst

    datas, tx = frames
    gaps = [900, 1200, 400, 1800]
    parts, pos = [], 0
    for i in range(4):
        parts.append(np.zeros(gaps[i], tx.dtype))
        parts.append(tx[i])
    stream = np.concatenate(parts)
    noisy = ot.channel(jnp.asarray(stream), snr=25.0, timing_error=True,
                       key=jax.random.key(5))

    results = decode_burst(noisy, payload_len=coded_len(96, "hamming"),
                           modulation=ot.Modulation.QPSK, fec="hamming",
                           data_len=96)
    assert len(results) == 4
    for i, (p, d, ok) in enumerate(results):
        assert ok
        np.testing.assert_array_equal(d, datas[i])


def test_fused_hamming_matches_unfused(frames):
    """The in-graph Hamming tail must equal the two-stage host composition:
    decode raw payload bytes (fec=None), then hamming.decode on host —
    including correction of injected single-bit errors per codeword."""
    datas, tx = frames
    spacing = tx.shape[1]
    plen = coded_len(96, "hamming")

    # flip one bit in one codeword of frame 2's payload region: re-encode a
    # corrupted codeword stream and splice it back through the modem
    coded = np.stack([np.asarray(hamming.encode(jnp.asarray(d)))
                      for d in datas])
    corrupted = coded.copy()
    corrupted[2, 3] ^= 0x10          # single bit error inside codeword bits
    tx2 = np.asarray(ot.encode(corrupted, guard_bands=True,
                               modulation=ot.Modulation.QPSK,
                               dtype=jnp.complex128))
    stream = jnp.asarray(tx2.reshape(-1))

    fused, oks = decode_regular(
        stream, n_frames=4, spacing=spacing, payload_len=plen,
        modulation=ot.Modulation.QPSK, fec="hamming", data_len=96)
    raw, _ = decode_regular(
        stream, n_frames=4, spacing=spacing, payload_len=plen,
        modulation=ot.Modulation.QPSK, fec=None)
    unfused = np.stack([np.asarray(hamming.decode(jnp.asarray(r), 96))
                        for r in raw])
    assert oks.all()
    np.testing.assert_array_equal(fused, unfused)
    for i in range(4):   # the injected error is corrected
        np.testing.assert_array_equal(fused[i], datas[i])


def test_fused_hamming_presync(frames):
    datas, tx = frames
    spacing = tx.shape[1]
    stream = jnp.asarray(tx.reshape(-1))
    payloads, oks = decode_regular(
        stream, n_frames=4, spacing=spacing,
        payload_len=coded_len(96, "hamming"), modulation=ot.Modulation.QPSK,
        fec="hamming", data_len=96, resync=False)
    assert oks.all()
    for i in range(4):
        np.testing.assert_array_equal(payloads[i], datas[i])


def test_encode_hamming_fused_matches_two_stage():
    rng = np.random.default_rng(9)
    data = rng.integers(0, 256, (3, 96), dtype=np.uint8)
    fused = np.asarray(ot.encode_hamming(jnp.asarray(data), guard_bands=True,
                                         modulation=ot.Modulation.QPSK))
    coded = np.asarray(hamming.encode(jnp.asarray(data)))
    two_stage = np.asarray(ot.encode(coded, guard_bands=True,
                                     modulation=ot.Modulation.QPSK))
    np.testing.assert_array_equal(fused, two_stage)


def test_decode_regular_planar_stream(frames):
    """decode_regular with a PLANAR f32[2, T] stream must match the complex
    path byte-for-byte in both presync and resync modes, including the
    fused Hamming tail (the end-to-end planar serving route)."""
    datas, tx = frames
    spacing = tx.shape[1] + 160
    stream = np.zeros(4 * spacing + 100, np.complex128)
    for i in range(4):
        stream[i * spacing + 37: i * spacing + 37 + tx.shape[1]] = tx[i]
    noisy = np.asarray(ot.channel(jnp.asarray(stream), snr=25.0,
                                  key=jax.random.key(7)))
    planar = jnp.asarray(np.stack([noisy.real, noisy.imag]).astype(np.float32))
    cplx = jnp.asarray(noisy.astype(np.complex64))
    kw = dict(n_frames=4, spacing=spacing,
              payload_len=coded_len(96, "hamming"),
              modulation=ot.Modulation.QPSK, fec="hamming", data_len=96)
    for resync in (False, True):
        pc, okc = decode_regular(cplx, resync=resync, **kw)
        pp, okp = decode_regular(planar, resync=resync, **kw)
        np.testing.assert_array_equal(pp, pc)
        np.testing.assert_array_equal(okp, okc)
        assert okp.all()
        for i in range(4):
            np.testing.assert_array_equal(pp[i], datas[i])


def test_first_sync_false_peak_regression():
    """Payload draws exist whose QPSK body out-correlates the true locking
    block under the raw |c|^2 statistic (~10% stronger peak mid-stream),
    killing EVERY frame of the buffer via the shared global sync.  The
    normalized matched filter (rho = |c|^2 / E_window, Cauchy-Schwarz
    bounded at the true block) restores the true peak.  This is the exact
    draw that broke the round-5 multichip dryrun at mesh data=2."""
    from ofdm_tpu.phy.streaming import _first_sync, _first_sync_planar
    from ofdm_tpu.config import DEFAULT_CONFIG as cfg
    rng = np.random.default_rng(1)
    _ = rng.integers(0, 256, (4, 48), dtype=np.uint8)   # dryrun's first draw
    user = rng.integers(0, 256, (4, 64), dtype=np.uint8)
    frames_ = np.asarray(ot.encode_hamming(jnp.asarray(user), guard_bands=True,
                                           modulation=ot.Modulation.QPSK))
    spacing = frames_.shape[-1]
    s = jnp.asarray(frames_.reshape(-1).astype(np.complex64))
    need = 4 * spacing + cfg.sym_len
    first = int(_first_sync(s, spacing=spacing, need=need, cfg=cfg))
    assert first == -1, f"false sync peak returned {first}"   # lag-0 quirk
    sp = jnp.stack([jnp.real(s), jnp.imag(s)])
    firstp = int(_first_sync_planar(sp, spacing=spacing, need=need, cfg=cfg))
    assert firstp == -1, f"planar false sync peak returned {firstp}"
    # and the full buffer decodes clean end to end
    p, ok = decode_regular(s, n_frames=4, spacing=spacing,
                           payload_len=coded_len(64, "hamming"),
                           modulation=ot.Modulation.QPSK, fec="hamming",
                           data_len=64)
    assert ok.all()
    np.testing.assert_array_equal(p, user)


def test_decode_regular_planar_variants(frames):
    """The planar-route compositions must all match the complex path
    byte-for-byte: both presync handoffs ("planar" and "complex"), and the
    pre-tiled f32[2, tiles, 128] stream form (rx.planar_stream_format's
    shape — the zero-copy serving upload)."""
    datas, tx = frames
    spacing = tx.shape[1] + 160
    stream = np.zeros(4 * spacing + 100, np.complex128)
    for i in range(4):
        stream[i * spacing + 37: i * spacing + 37 + tx.shape[1]] = tx[i]
    noisy = np.asarray(ot.channel(jnp.asarray(stream), snr=25.0,
                                  key=jax.random.key(9)))
    planar = np.stack([noisy.real, noisy.imag]).astype(np.float32)
    tiles = -(-planar.shape[-1] // 128)
    tiled = jnp.asarray(np.pad(
        planar, ((0, 0), (0, tiles * 128 - planar.shape[-1]))
    ).reshape(2, tiles, 128))
    cplx = jnp.asarray(noisy.astype(np.complex64))
    kw = dict(n_frames=4, spacing=spacing,
              payload_len=coded_len(96, "hamming"),
              modulation=ot.Modulation.QPSK, fec="hamming", data_len=96)
    for resync in (False, True):
        pc, okc = decode_regular(cplx, resync=resync, **kw)
        assert okc.all()
        for handoff in ("planar", "complex", "split"):
            pp, okp = decode_regular(jnp.asarray(planar), resync=resync,
                                     planar_handoff=handoff, **kw)
            np.testing.assert_array_equal(pp, pc)
            np.testing.assert_array_equal(okp, okc)
        pt, okt = decode_regular(tiled, resync=resync, **kw)
        np.testing.assert_array_equal(pt, pc)
        np.testing.assert_array_equal(okt, okc)
        for i in range(4):
            np.testing.assert_array_equal(pc[i], datas[i])


def test_planar_format_contracts():
    """The pinned-layout helpers must keep their layout contracts: row-major
    major_to_minor tuples matching the documented argument ranks (batch
    [R, 2, tiles, 128] and stream [2, tiles, 128]) on the default device —
    bench.py and serving pipelines pin buffers against exactly these."""
    bf = ot.planar_input_format()
    sf = ot.planar_stream_format()
    assert tuple(bf.layout.major_to_minor) == (0, 1, 2, 3)
    assert tuple(sf.layout.major_to_minor) == (0, 1, 2)
    assert bf.sharding.device_set == {jax.devices()[0]}
    assert sf.sharding.device_set == {jax.devices()[0]}
