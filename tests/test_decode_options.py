"""Tests for decode_frame's production options (sync dtype, search window,
lowering choices)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import ofdm_tpu as ot


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(0)
    data = rng.integers(0, 256, (4, 120), dtype=np.uint8)
    tx = ot.encode(data, guard_bands=True, modulation=ot.Modulation.QPSK)
    rx = ot.channel(tx, snr=30.0, timing_error=True, key=jax.random.key(1))
    nb = ot.n_data_blocks(120, ot.Modulation.QPSK, True)
    return data, rx, nb


def _payload(out):
    return np.asarray(out)[:, 16:16 + 120]


def test_default(setup):
    data, rx, nb = setup
    out = ot.decode_frame(rx, n_blocks=nb, guard_bands=True,
                          modulation=ot.Modulation.QPSK)
    np.testing.assert_array_equal(_payload(out), data)


def test_bf16_sync(setup):
    data, rx, nb = setup
    out = ot.decode_frame(rx, n_blocks=nb, guard_bands=True,
                          modulation=ot.Modulation.QPSK,
                          sync_dtype=jnp.bfloat16)
    np.testing.assert_array_equal(_payload(out), data)


def test_fft_sync(setup):
    data, rx, nb = setup
    out = ot.decode_frame(rx, n_blocks=nb, guard_bands=True,
                          modulation=ot.Modulation.QPSK, sync_dtype="fft")
    np.testing.assert_array_equal(_payload(out), data)


def test_search_window(setup):
    data, rx, nb = setup
    # channel delay is ~9 samples; a 256-sample acquisition window suffices
    out = ot.decode_frame(rx, n_blocks=nb, guard_bands=True,
                          modulation=ot.Modulation.QPSK, search_window=256)
    np.testing.assert_array_equal(_payload(out), data)


def test_search_window_bounds_acquisition(setup):
    data, rx, nb = setup
    # push the frame 600 samples in: a 256-sample window misses it, a
    # 1024-sample window finds it
    delayed = jnp.concatenate(
        [jnp.zeros((rx.shape[0], 600), rx.dtype), rx], axis=-1)
    missed = ot.decode_frame(delayed, n_blocks=nb, guard_bands=True,
                             modulation=ot.Modulation.QPSK, search_window=256)
    assert (_payload(missed) != data).any()
    found = ot.decode_frame(delayed, n_blocks=nb, guard_bands=True,
                            modulation=ot.Modulation.QPSK, search_window=1024)
    np.testing.assert_array_equal(_payload(found), data)


@pytest.mark.parametrize("mod,gb", [(ot.Modulation.QAM64, True),
                                    (ot.Modulation.QAM256, True),
                                    (ot.Modulation.BPSK, False)])
def test_derot_matrix_parity(mod, gb):
    """derot_impl="matrix" (CFO folded into a per-row DFT matrix) must be
    byte-identical to the stream derotation across modulations, guard
    settings and nonzero CFO draws (the channel draws CFO per row)."""
    rng = np.random.default_rng(7)
    data = rng.integers(0, 256, (6, 240), dtype=np.uint8)
    tx = ot.encode(data, guard_bands=gb, modulation=mod)
    snr = 55.0 if mod == ot.Modulation.QAM256 else 35.0
    rx = ot.channel(tx, snr=snr, timing_error=True, key=jax.random.key(5))
    nb = ot.n_data_blocks(240, mod, gb)
    a = ot.decode_frame(rx, n_blocks=nb, guard_bands=gb, modulation=mod,
                        derot_impl="stream")
    b = ot.decode_frame(rx, n_blocks=nb, guard_bands=gb, modulation=mod,
                        derot_impl="matrix")
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    np.testing.assert_array_equal(np.asarray(b)[:, 16:16 + 240], data)


def test_derot_matrix_diag_parity():
    """The matrix path's diagnostics (h_k, chunk6 taps, equalized) must
    match the stream path to f32 tolerance — they are computed from
    separately-derotated small tensors."""
    from ofdm_tpu.phy.rx import decode_aligned
    rng = np.random.default_rng(9)
    data = rng.integers(0, 256, (3, 120), dtype=np.uint8)
    tx = ot.encode(data, guard_bands=True, modulation=ot.Modulation.QPSK)
    rx = ot.channel(tx, snr=40.0, key=jax.random.key(2))
    nb = ot.n_data_blocks(120, ot.Modulation.QPSK, True)
    from ofdm_tpu.config import DEFAULT_CONFIG as cfg
    n_chunks = cfg.n_sync_chunks + nb
    aligned = rx[..., : n_chunks * cfg.sym_len]
    _, da = decode_aligned(aligned, n_chunks=n_chunks, guard_bands=True,
                           modulation=ot.Modulation.QPSK,
                           cfo_estimator="coherent", derot_impl="stream")
    _, db = decode_aligned(aligned, n_chunks=n_chunks, guard_bands=True,
                           modulation=ot.Modulation.QPSK,
                           cfo_estimator="coherent", derot_impl="matrix")
    for k in ("f_delta", "h_k", "chunk6_pre", "chunk6_post", "equalized"):
        np.testing.assert_allclose(np.asarray(da[k]), np.asarray(db[k]),
                                   rtol=2e-4, atol=2e-4, err_msg=k)


@pytest.mark.parametrize("mod,gb", [(ot.Modulation.QPSK, True),
                                    (ot.Modulation.QAM64, True),
                                    (ot.Modulation.QAM256, True),
                                    (ot.Modulation.BPSK, False)])
def test_decode_planar_matrix_parity(mod, gb):
    """decode_planar_matrix (the planar f32 handoff from the fused GPU
    sync+align kernel) must be byte-identical to
    decode_aligned's matrix path and decode bytes exactly, across
    modulations, guard settings, and nonzero CFO draws."""
    from ofdm_tpu.config import DEFAULT_CONFIG as cfg
    from ofdm_tpu.phy.rx import decode_aligned, decode_planar_matrix
    rng = np.random.default_rng(17)
    data = rng.integers(0, 256, (5, 240), dtype=np.uint8)
    tx = ot.encode(data, guard_bands=gb, modulation=mod)
    snr = 55.0 if mod == ot.Modulation.QAM256 else 35.0
    rx = ot.channel(tx, snr=snr, key=jax.random.key(6))
    nb = ot.n_data_blocks(240, mod, gb)
    n_chunks = cfg.n_sync_chunks + nb
    aligned = rx[..., : n_chunks * cfg.sym_len].astype(jnp.complex64)
    planes = jnp.stack([jnp.real(aligned), jnp.imag(aligned)], axis=-2)
    a, _ = decode_aligned(aligned, n_chunks=n_chunks, guard_bands=gb,
                          modulation=mod, cfo_estimator="coherent",
                          derot_impl="matrix")
    b, _ = decode_planar_matrix(planes, n_chunks=n_chunks, guard_bands=gb,
                                modulation=mod, cfo_estimator="coherent")
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    np.testing.assert_array_equal(np.asarray(b)[:, 16:16 + 240], data)


def test_fused_planar_chain_parity():
    """End-to-end: the fused GPU sync+align kernel (interpret mode) +
    decode_planar_matrix == decode_frame's XLA route, byte for byte, with
    timing error so the in-kernel sync offset actually does work."""
    from ofdm_tpu.config import DEFAULT_CONFIG as cfg
    from ofdm_tpu.kernels.sync_align import sync_align
    from ofdm_tpu import constants
    from ofdm_tpu.phy.rx import decode_planar_matrix
    rng = np.random.default_rng(23)
    data = rng.integers(0, 256, (4, 120), dtype=np.uint8)
    tx = ot.encode(data, guard_bands=True, modulation=ot.Modulation.QAM16)
    rx = ot.channel(tx, snr=35.0, timing_error=True, key=jax.random.key(8))
    rx = rx.astype(jnp.complex64)
    nb = ot.n_data_blocks(120, ot.Modulation.QAM16, True)
    n_chunks = cfg.n_sync_chunks + nb
    need = n_chunks * cfg.sym_len
    rx = jnp.pad(rx, ((0, 0), (0, max(0, need - rx.shape[-1]))))
    planes = jnp.stack([jnp.real(rx), jnp.imag(rx)], axis=1)
    win = sync_align(planes, constants.locking_for(cfg), need, interpret=True)
    out, _ = decode_planar_matrix(win, n_chunks=n_chunks, guard_bands=True,
                                  modulation=ot.Modulation.QAM16,
                                  cfo_estimator="coherent")
    ref = ot.decode_frame(rx, n_blocks=nb, guard_bands=True,
                          modulation=ot.Modulation.QAM16, align_impl="xla")
    np.testing.assert_array_equal(np.asarray(out), np.asarray(ref))
    np.testing.assert_array_equal(np.asarray(out)[:, 16:16 + 120], data)


def test_1d_input(setup):
    data, rx, nb = setup
    out = ot.decode_frame(rx[0], n_blocks=nb, guard_bands=True,
                          modulation=ot.Modulation.QPSK)
    np.testing.assert_array_equal(np.asarray(out)[16:16 + 120], data[0])


@pytest.mark.parametrize("kw", [
    {"align_impl": "fused"}, {"align_impl": "fused_planar"},
    {"align_impl": "pallas"}, {"align_impl": "chunked"},
    {"demod_impl": "pallas"}, {"demod_impl": "interpret"},
], ids=lambda kw: "-".join(f"{k}={v}" for k, v in kw.items()))
def test_removed_lowering_values_raise(setup, kw):
    """Lowerings that no longer exist are an error, not a silent
    fallback: an unknown align_impl value, and the demod_impl argument
    itself (its one remaining value was the XLA tail)."""
    data, rx, nb = setup
    error = TypeError if "demod_impl" in kw else ValueError
    with pytest.raises(error, match="unknown|demod_impl"):
        ot.decode_frame(rx, n_blocks=nb, guard_bands=True,
                        modulation=ot.Modulation.QPSK, **kw)
