"""Tests for the streaming feed harness and host<->device transfer shims."""

import numpy as np
import pytest

from ofdm_tpu.core.transfer import to_device, to_host
from ofdm_tpu.io.feed import SampleFeed, double_buffered, synthetic_captures


class TestTransfer:
    def test_complex_roundtrip(self):
        rng = np.random.default_rng(0)
        x = rng.standard_normal(64) + 1j * rng.standard_normal(64)
        d = to_device(x)
        back = to_host(d)
        np.testing.assert_allclose(back, x, atol=1e-12)

    def test_real_passthrough(self):
        x = np.arange(10, dtype=np.float32)
        np.testing.assert_array_equal(to_host(to_device(x)), x)

    def test_numpy_input_unchanged(self):
        x = np.ones(5, np.complex128)
        assert to_host(x) is x

    def test_dtype_override(self):
        import jax.numpy as jnp
        x = np.ones(8, np.complex128)
        assert to_device(x, dtype=jnp.complex64).dtype == jnp.complex64

    def test_complex64_roundtrip_bit_exact(self):
        rng = np.random.default_rng(1)
        x = (rng.standard_normal(4096)
             + 1j * rng.standard_normal(4096)).astype(np.complex64)
        d = to_device(x)
        assert d.dtype == np.complex64
        back = to_host(d)
        assert back.dtype == np.complex64
        np.testing.assert_array_equal(back, x)

    def test_complex128_kept_under_x64(self):
        x = np.exp(1j * np.linspace(0, 1, 33))
        d = to_device(x)
        assert d.dtype == np.complex128      # the tests enable x64
        np.testing.assert_array_equal(to_host(d), x)

    def test_to_device_planar_layout(self):
        from ofdm_tpu.core.transfer import to_device_planar
        x = (np.arange(200) + 1j * np.arange(200)[::-1]).astype(np.complex64)
        p = np.asarray(to_device_planar(x))
        assert p.shape == (2, 384) and p.dtype == np.float32
        np.testing.assert_array_equal(p[0, :200], x.real)
        np.testing.assert_array_equal(p[1, :200], x.imag)
        assert not p[:, 200:].any()


class TestFeed:
    def test_backpressure_and_order(self):
        bufs = [np.full(10, i, np.complex64) for i in range(5)]
        with SampleFeed(iter(bufs), depth=1) as feed:
            got = [int(b[0].real) for b in feed]
        assert got == [0, 1, 2, 3, 4]

    def test_producer_exception_propagates(self):
        def bad():
            yield np.zeros(4)
            raise RuntimeError("capture died")

        with pytest.raises(RuntimeError, match="capture died"):
            with SampleFeed(bad()) as feed:
                list(feed)

    def test_double_buffered_yields_all(self):
        bufs = [np.full(4, i, np.complex64) for i in range(4)]
        out = list(double_buffered(bufs, to_device))
        assert len(out) == 4
        np.testing.assert_array_equal(to_host(out[2]),
                                      np.full(4, 2, np.complex64))

    def test_double_buffered_empty(self):
        assert list(double_buffered([], to_device)) == []

    def test_synthetic_captures_contain_frames(self):
        frame = np.ones(100, np.complex64)
        bufs = list(synthetic_captures(3, 2, lambda i: frame, 1000, seed=1))
        assert len(bufs) == 3
        # frames raise total power well above the noise floor
        for b in bufs:
            assert np.abs(b).max() > 0.5


def test_to_device_planar_decode():
    """Planar upload (complex or plane-pair input) feeds decode_frame_planar
    byte-exactly — the end-to-end planar serving path with no complex array
    anywhere between capture and bytes."""
    import jax
    import jax.numpy as jnp

    import ofdm_tpu as ot
    from ofdm_tpu.core.transfer import to_device_planar
    rng = np.random.default_rng(3)
    data = rng.integers(0, 256, (2, 120), dtype=np.uint8)
    tx = ot.encode(data, guard_bands=True, modulation=ot.Modulation.QPSK,
                   dtype=jnp.complex64)
    rx = np.asarray(ot.channel(tx, snr=35.0, key=jax.random.key(1)))
    nb = ot.n_data_blocks(120, ot.Modulation.QPSK, True)
    p = to_device_planar(rx)
    assert p.dtype == jnp.float32 and p.shape[-2] == 2
    assert p.shape[-1] % 128 == 0
    out = np.asarray(ot.decode_frame_planar(
        p, n_blocks=nb, guard_bands=True, modulation=ot.Modulation.QPSK))
    np.testing.assert_array_equal(out[:, 16:16 + 120], data)
    p2 = to_device_planar((rx.real.astype(np.float32),
                           rx.imag.astype(np.float32)))
    out2 = np.asarray(ot.decode_frame_planar(
        p2, n_blocks=nb, guard_bands=True, modulation=ot.Modulation.QPSK))
    np.testing.assert_array_equal(out, out2)
