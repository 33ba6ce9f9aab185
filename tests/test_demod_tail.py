"""The XLA post-DFT tail (equalize, pilot phase, packed demod) vs the
unpacked reference demapper on the decoder's own equalized symbols.

decode_aligned's packed SoA demod must turn ``diag["equalized"]`` into
exactly the bytes ``bits_to_bytes(demodulate_symbols(...))`` gives, across
modulations, guard-band modes and the CFO path, and those bytes must carry
the payload.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import ofdm_tpu as ot
from ofdm_tpu.config import DEFAULT_CONFIG as cfg
from ofdm_tpu.core.bitops import bits_to_bytes
from ofdm_tpu.phy.modulation import demodulate_symbols
from ofdm_tpu.phy.rx import decode_aligned


def _aligned(mod, guard_bands, cfo, batch=3, payload=256, snr=45.0):
    rng = np.random.default_rng(7)
    data = rng.integers(0, 256, (batch, payload), dtype=np.uint8)
    tx = ot.encode(data, guard_bands=guard_bands, modulation=mod,
                   dtype=jnp.complex64)
    rx = ot.channel(tx, snr=snr, timing_error=cfo, key=jax.random.key(3))
    nb = ot.n_data_blocks(payload, mod, guard_bands)
    n_chunks = cfg.n_sync_chunks + nb
    need = n_chunks * cfg.sym_len
    rx = jnp.pad(rx.astype(jnp.complex64),
                 ((0, 0), (0, max(0, need - rx.shape[-1]))))
    off = jnp.clip(ot.sync_offset(rx), 0, rx.shape[-1] - need)
    aligned = jax.vmap(lambda r, o: jax.lax.dynamic_slice_in_dim(
        r, o, need))(rx, off)
    return data, aligned, n_chunks


def _check(mod, guard_bands, cfo):
    data, aligned, n_chunks = _aligned(mod, guard_bands, cfo)
    for derot in ("stream", "matrix"):
        out, diag = decode_aligned(aligned, n_chunks=n_chunks,
                                   guard_bands=guard_bands, modulation=mod,
                                   cfo_estimator="coherent",
                                   derot_impl=derot)
        want = bits_to_bytes(demodulate_symbols(diag["equalized"], mod))
        np.testing.assert_array_equal(np.asarray(out), np.asarray(want))
        np.testing.assert_array_equal(
            np.asarray(out)[:, 16:16 + data.shape[1]], data)


@pytest.mark.parametrize("mod,guard_bands", [
    (ot.Modulation.QAM64, True),
    (ot.Modulation.QPSK, True),
    (ot.Modulation.QAM256, True),
    (ot.Modulation.BPSK, False),
    (ot.Modulation.QAM16, False),
])
def test_xla_tail_matches_unpacked_demod(mod, guard_bands):
    _check(mod, guard_bands, cfo=False)


def test_xla_tail_matches_unpacked_demod_with_cfo():
    _check(ot.Modulation.QAM64, True, cfo=True)
