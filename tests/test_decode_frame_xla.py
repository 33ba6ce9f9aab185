"""decode_frame's XLA sync+align route vs the float64 sequential oracle.

The route every platform without the fused GPU kernel takes (and the
reference the kernel is checked against): payload bytes EXACT vs the
transmitted data and vs tests/oracle_rx.py, across modulations, guard-band
modes, bounded acquisition, frame starts on every alignment class, a custom
frame geometry and the planar entry forms.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import ofdm_tpu as ot
from ofdm_tpu.config import DEFAULT_CONFIG as cfg

from .oracle_rx import oracle_decode


def _frame_batch(rng, n_rows, payload_len, mod, gb, snr, key, timing=True,
                 c=cfg):
    data = rng.integers(0, 256, (n_rows, payload_len), dtype=np.uint8)
    tx = ot.encode(data, guard_bands=gb, modulation=mod, cfg=c,
                   dtype=jnp.complex64)
    rx = ot.channel(tx, snr=snr, timing_error=timing,
                    key=jax.random.key(key)).astype(jnp.complex64)
    nb = ot.n_data_blocks(payload_len, mod, gb, c)
    need = (c.n_sync_chunks + nb) * c.sym_len
    rx = jnp.pad(rx, ((0, 0), (0, max(0, need + 40 - rx.shape[-1]))))
    return data, rx, nb


def _xla(rx, nb, gb, mod, **kw):
    return np.asarray(ot.decode_frame(rx, n_blocks=nb, guard_bands=gb,
                                      modulation=mod, align_impl="xla", **kw))


@pytest.mark.parametrize("mod,snr", [
    (ot.Modulation.BPSK, 30.0),
    (ot.Modulation.QPSK, 30.0),
    (ot.Modulation.QAM16, 35.0),
    (ot.Modulation.QAM64, 45.0),
    (ot.Modulation.QAM256, 55.0),
])
def test_payload_exact_all_modulations(mod, snr):
    rng = np.random.default_rng(5)
    data, rx, nb = _frame_batch(rng, 4, 240, mod, True, snr, key=3,
                                timing=False)
    out = _xla(rx, nb, True, mod)
    np.testing.assert_array_equal(out[:, 16:16 + 240], data)
    for r in range(2):
        want = oracle_decode(np.asarray(rx[r]), True, mod.value)
        np.testing.assert_array_equal(out[r, :16 + 240], want[:16 + 240])


def test_no_guard_bands():
    rng = np.random.default_rng(6)
    data, rx, nb = _frame_batch(rng, 3, 200, ot.Modulation.QPSK, False,
                                30.0, key=4)
    out = _xla(rx, nb, False, ot.Modulation.QPSK)
    np.testing.assert_array_equal(out[:, 16:16 + 200], data)


def test_search_window_bounds_acquisition():
    rng = np.random.default_rng(8)
    data, rx, nb = _frame_batch(rng, 2, 120, ot.Modulation.QPSK, True,
                                35.0, key=6, timing=False)
    # push the frame 600 samples in; a 1024 window finds it, 64 misses it
    delayed = jnp.concatenate(
        [jnp.zeros((rx.shape[0], 600), rx.dtype), rx], axis=-1)
    found = _xla(delayed, nb, True, ot.Modulation.QPSK, search_window=1024)
    np.testing.assert_array_equal(found[:, 16:16 + 120], data)
    missed = _xla(delayed, nb, True, ot.Modulation.QPSK, search_window=64)
    assert (missed[:, 16:16 + 120] != data).any()


def test_boundary_offsets():
    """Frame starts on symbol and 128-lag tile boundaries."""
    rng = np.random.default_rng(9)
    payload = rng.integers(0, 256, 90, dtype=np.uint8)
    tx = np.asarray(ot.encode(payload, guard_bands=True,
                              modulation=ot.Modulation.QPSK,
                              dtype=jnp.complex64))
    nb = ot.n_data_blocks(90, ot.Modulation.QPSK, True)
    need = (cfg.n_sync_chunks + nb) * cfg.sym_len
    offs = [0, 1, 79, 80, 127, 128, 129, 255]
    t = need + 400
    s = 0.003 * (rng.standard_normal((len(offs), t))
                 + 1j * rng.standard_normal((len(offs), t)))
    for i, off in enumerate(offs):
        s[i, off:off + tx.shape[-1]] += tx
    s = jnp.asarray(s.astype(np.complex64))
    out = _xla(s, nb, True, ot.Modulation.QPSK)
    np.testing.assert_array_equal(out[:, 16:16 + 90],
                                  np.tile(payload, (len(offs), 1)))


def test_custom_geometry():
    """A geometry beyond sym_len=80 (sym 96) with a PRN locking sequence."""
    from ofdm_tpu.config import FrameConfig
    c2 = FrameConfig(n_fft=80, cp_len=16, locking_seed=7,
                     pilot_indices=(3, 20, 50, 70))
    rng = np.random.default_rng(14)
    data, rx, nb = _frame_batch(rng, 3, 100, ot.Modulation.QPSK, False, 35.0,
                                key=2, timing=False, c=c2)
    out = np.asarray(ot.decode_frame(rx, n_blocks=nb, guard_bands=False,
                                     modulation=ot.Modulation.QPSK, cfg=c2))
    np.testing.assert_array_equal(out[:, 16:16 + 100], data)


def test_decode_frame_planar_entry_forms():
    """decode_frame_planar matches decode_frame for the [R, 2, T] and the
    pre-tiled [R, 2, tiles, 128] (planar_input_format) argument forms."""
    rng = np.random.default_rng(12)
    data, rx, nb = _frame_batch(rng, 3, 120, ot.Modulation.QPSK, True,
                                35.0, key=9)
    planes = jnp.stack([jnp.real(rx), jnp.imag(rx)], axis=1)
    ref = np.asarray(ot.decode_frame(rx, n_blocks=nb, guard_bands=True,
                                     modulation=ot.Modulation.QPSK))
    pl_out = np.asarray(ot.decode_frame_planar(
        planes, n_blocks=nb, guard_bands=True,
        modulation=ot.Modulation.QPSK))
    np.testing.assert_array_equal(pl_out, ref)
    t = planes.shape[-1]
    tiles = -(-t // 128) + 1
    p4 = jnp.pad(planes, ((0, 0), (0, 0), (0, tiles * 128 - t))
                 ).reshape(planes.shape[0], 2, tiles, 128)
    p4_out = np.asarray(ot.decode_frame_planar(
        p4, n_blocks=nb, guard_bands=True, modulation=ot.Modulation.QPSK))
    np.testing.assert_array_equal(p4_out, ref)
    np.testing.assert_array_equal(ref[:, 16:16 + 120], data)


def test_decode_frame_planar_sharded_matches():
    """The data-sharded planar decode equals the single-device decode, and
    each device holds its own rows."""
    from ofdm_tpu.parallel.mesh import make_mesh
    from ofdm_tpu.parallel.pipeline import decode_frame_planar_sharded
    mesh = make_mesh(n_data=4, devices=jax.devices()[:4])
    rng = np.random.default_rng(13)
    data, rx, nb = _frame_batch(rng, 8, 48, ot.Modulation.QPSK, True, 40.0,
                                key=7)
    planes = jnp.stack([jnp.real(rx), jnp.imag(rx)], axis=1)
    out = decode_frame_planar_sharded(planes, mesh, n_blocks=nb,
                                      guard_bands=True,
                                      modulation=ot.Modulation.QPSK)
    assert len({s.device for s in out.addressable_shards}) == 4
    ref = _xla(rx, nb, True, ot.Modulation.QPSK)
    np.testing.assert_array_equal(np.asarray(out), ref)
    np.testing.assert_array_equal(ref[:, 16:16 + 48], data)
