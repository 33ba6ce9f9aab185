"""Kernel tests: the GPU sync kernel (kernels/sync_align.py) in the Pallas
interpreter and lowered for CUDA, and the packed SoA modem primitives."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ofdm_tpu import constants
from ofdm_tpu.config import DEFAULT_CONFIG

TPL = np.asarray(constants.locking_for(DEFAULT_CONFIG)).astype(np.complex64)


def _bursts(t, delays, seed, amp=1.0, extra=()):
    """Rows of low noise with the locking template at each delay."""
    rng = np.random.default_rng(seed)
    s = 0.01 * (rng.standard_normal((len(delays), t))
                + 1j * rng.standard_normal((len(delays), t)))
    for i, d in enumerate(delays):
        s[i, d:d + 80] += amp * TPL
    for i, d in extra:
        s[i, d:d + 80] += amp * TPL
    return jnp.asarray(s.astype(np.complex64))


def _planes(s):
    return jnp.stack([jnp.real(s), jnp.imag(s)], axis=1)


def _xla_offsets(s, need, search_window=None):
    from ofdm_tpu.phy.rx import sync_offset
    scan = s if search_window is None else s[:, :search_window + 80]
    return np.clip(np.asarray(sync_offset(scan, DEFAULT_CONFIG)), 0,
                   s.shape[-1] - need)


def test_fused_sync_align_matches_xla():
    """The GPU sync kernel must reproduce sync_offset + alignment exactly
    on well-separated peaks (delays spanning tiles, lag blocks, program
    splits and the clip edge)."""
    from ofdm_tpu.kernels.sync_align import sync_align
    from ofdm_tpu.phy.rx import _planar_align

    t, need = 2560, 2400
    s = _bursts(t, [0, 1, 63, 127, 128, 129, 150, 200], seed=5)
    offs = _xla_offsets(s, need)
    ref = np.asarray(_planar_align(s, jnp.asarray(offs), need))
    got = np.asarray(sync_align(_planes(s), TPL, need, interpret=True))
    np.testing.assert_array_equal(got[:, 0], ref.real)
    np.testing.assert_array_equal(got[:, 1], ref.imag)


@pytest.mark.parametrize("t,need,delays", [
    # shorter than one block of LAG_ROWS x TILE = 512 lags
    (500, 300, [0, 1, 31, 32, 127, 199]),
    # exactly one program's BLOCKS_PER_PROG blocks
    (2048, 1000, [0, 511, 512, 513, 1023, 1024, 1047]),
    # a second, partial program
    (2600, 2400, [0, 31, 32, 127, 128, 199]),
    # block and split boundaries across three programs
    (5000, 2400, [0, 1, 31, 32, 511, 512, 513, 1023, 1024, 2047, 2048, 2599]),
], ids=lambda v: str(v) if isinstance(v, int) else None)
def test_sync_offsets_block_geometries(t, need, delays):
    """The committed block geometry finds the XLA offsets at row lengths
    that end inside a block, on a program edge and past one, including
    peaks on block and split boundaries."""
    from ofdm_tpu.kernels.sync_align import sync_offsets
    s = _bursts(t, delays, seed=6)
    got = np.asarray(sync_offsets(_planes(s), TPL, need, interpret=True))
    np.testing.assert_array_equal(got, _xla_offsets(s, need))


@pytest.mark.parametrize("search_window", [40, 100, 1100])
def test_sync_offsets_search_window_matches_xla(search_window):
    """A bounded scan sees the truncated stream, as the XLA route does, so a
    frame beyond the window is missed the same way."""
    from ofdm_tpu.kernels.sync_align import sync_offsets
    t, need = 3000, 1600
    s = _bursts(t, [10, 90, 95, 150, 700, 1200], seed=7)
    got = np.asarray(sync_offsets(_planes(s), TPL, need,
                                  search_window=search_window,
                                  interpret=True))
    np.testing.assert_array_equal(got, _xla_offsets(s, need, search_window))


def test_sync_offsets_first_occurrence_on_ties():
    """Two identical bursts a multiple of 128 samples apart (so every tiling
    computes both peaks with the same arithmetic, an exact tie): the earlier
    one wins within one block (100/356), across blocks of one program
    (200/1736) and across program splits (300/4908), like jnp.argmax."""
    from ofdm_tpu.kernels.sync_align import sync_offsets
    t, need = 6000, 1000
    base = np.zeros((3, t), np.complex64)
    for i, (a, b) in enumerate([(100, 356), (200, 1736), (300, 4908)]):
        base[i, a:a + 80] = TPL
        base[i, b:b + 80] = TPL
    got = np.asarray(sync_offsets(_planes(jnp.asarray(base)), TPL, need,
                                  interpret=True))
    np.testing.assert_array_equal(got, [99, 199, 299])
    np.testing.assert_array_equal(got, _xla_offsets(jnp.asarray(base), need))


def test_sync_align_window_clip():
    """Offsets clip to T - need, and the clipped window is the stream tail."""
    from ofdm_tpu.kernels.sync_align import sync_align
    t, need = 2000, 1500
    s = _bursts(t, [1800, 600], seed=8)
    win = np.asarray(sync_align(_planes(s), TPL, need, interpret=True))
    planes = np.asarray(_planes(s))
    np.testing.assert_array_equal(win[0], planes[0, :, t - need:])
    np.testing.assert_array_equal(win[1], planes[1, :, t - need:])


def test_sync_kernel_supports_real_templates_only():
    from ofdm_tpu.config import FrameConfig
    from ofdm_tpu.kernels.sync_align import supports
    assert supports(TPL)
    assert not supports(TPL * np.exp(0.7j))
    prn = constants.locking_for(FrameConfig(locking_seed=7))
    assert not supports(prn)


def test_sync_kernel_lowers_for_cuda():
    """The Triton lowering accepts the kernel at the config-2 width (power-of-
    two loads, dot shapes, masks) — the part of GPU compilation a CPU can
    check; the card compiles the emitted Triton IR."""
    from ofdm_tpu.kernels.sync_align import sync_align
    planes = jax.ShapeDtypeStruct((256, 2, 19120), jnp.float32)
    for sw in (None, 80):
        lowered = jax.jit(lambda p, sw=sw: sync_align(
            p, TPL, 19120, search_window=sw)).trace(planes).lower(
                lowering_platforms=("cuda",))
        assert "triton" in lowered.as_text()


def test_auto_route_selection(monkeypatch):
    """align_impl="auto" takes the kernel only on the GPU, for a whole-row
    scan of complex64 input, the real template and full-precision sync."""
    from ofdm_tpu.config import FrameConfig
    from ofdm_tpu.phy import rx
    c64 = jnp.zeros((2, 8), jnp.complex64)
    assert not rx._use_triton_sync(c64, TPL, None, None)    # CPU here
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    assert rx._use_triton_sync(c64, TPL, None, None)
    assert not rx._use_triton_sync(c64, TPL, None, 80)      # bounded scan
    assert not rx._use_triton_sync(c64.astype(jnp.complex128), TPL, None,
                                   None)
    assert not rx._use_triton_sync(c64, TPL, jnp.bfloat16, None)
    prn = constants.locking_for(FrameConfig(locking_seed=7))
    assert not rx._use_triton_sync(c64, prn, None, None)


@pytest.mark.gpu
def test_sync_kernel_compiled_matches_xla():
    """On a GPU: the compiled kernel finds the XLA offsets."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU (chip_smoke.py sync_ab runs this "
                    "check at the config-2 shape)")
    from ofdm_tpu.kernels.sync_align import sync_offsets
    t, need = 5000, 2400
    s = _bursts(t, [0, 1, 127, 128, 1024, 2599], seed=9)
    got = np.asarray(sync_offsets(_planes(s), TPL, need))
    np.testing.assert_array_equal(got, _xla_offsets(s, need))


def test_demodulate_symbols_packed_parity():
    """Packed SoA demod == bits_to_bytes(demodulate_symbols(...)) for every
    scheme, including QPSK's im==0 fallthrough edges and non-group-aligned
    symbol counts."""
    from ofdm_tpu.core.bitops import bits_to_bytes
    from ofdm_tpu.phy.modulation import (Modulation, demodulate_symbols,
                                         demodulate_symbols_packed)

    rng = np.random.default_rng(21)
    for scheme in Modulation:
        for n_sym in [4, 7, 12, 33, 128]:
            re = rng.normal(0, 4, (3, n_sym))
            im = rng.normal(0, 4, (3, n_sym))
            # exercise exact-zero edges (QPSK decision table fallthrough)
            re[0, : n_sym // 2] = 0.0
            im[1, : n_sym // 2] = 0.0
            syms = jnp.asarray(re + 1j * im, jnp.complex64)
            want = np.asarray(bits_to_bytes(demodulate_symbols(syms, scheme)))
            got = np.asarray(demodulate_symbols_packed(syms, scheme))
            np.testing.assert_array_equal(
                got, want, err_msg=f"{scheme} n_sym={n_sym}")


def test_modulate_bytes_packed_parity():
    """SoA byte->symbol mapping == modulate_bits(bytes_to_bits(...)) exactly
    (same level constants, same zero-padded tail symbol) for every scheme,
    both dtypes, and non-group-aligned byte counts."""
    from ofdm_tpu.core.bitops import bytes_to_bits
    from ofdm_tpu.phy.modulation import (Modulation, modulate_bits,
                                         modulate_bytes_packed)

    rng = np.random.default_rng(22)
    for scheme in Modulation:
        for n in [1, 2, 3, 5, 17, 96]:
            data = jnp.asarray(rng.integers(0, 256, (2, n), dtype=np.uint8))
            for dtype in (jnp.complex64, jnp.complex128):
                want = np.asarray(modulate_bits(bytes_to_bits(data), scheme,
                                                dtype=dtype))
                got = np.asarray(modulate_bytes_packed(data, scheme,
                                                       dtype=dtype))
                np.testing.assert_array_equal(
                    got, want, err_msg=f"{scheme} n={n} {dtype}")
