"""Bit-exactness of the batched decoder vs the sequential oracle.

The oracle (tests/oracle_rx.py) implements the reference receiver math as
naive float64 loops.  The production decoder must produce byte-identical raw
output (pre-truncation, header included) on noisy channel realizations —
the strongest available stand-in for "matches src/receiver.rs bit-exactly"
in an environment without the Rust toolchain.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import ofdm_tpu as ot
from ofdm_tpu.phy.rx import decode_aligned

from .oracle_rx import oracle_decode


@pytest.mark.parametrize("gb,mod,snr,cfo,key", [
    (False, "bpsk", 30.0, False, 1),
    (False, "qpsk", 30.0, True, 2),
    (True, "bpsk", 20.0, True, 3),
    (True, "qpsk", 25.0, False, 4),
    (True, "qpsk", 10.0, True, 5),   # noisy: bit errors present, still equal
])
def test_jax_decoder_matches_oracle(gb, mod, snr, cfo, key):
    data = bytes(range(120))
    tx = ot.encode(data, guard_bands=gb, modulation=ot.Modulation(mod),
                   dtype=jnp.complex128)
    rx = np.asarray(ot.channel(tx, snr=snr, timing_error=cfo,
                               key=jax.random.key(key)))

    expected = oracle_decode(rx, gb, mod)

    # production path: replicate the host decode's raw (untruncated) output
    off = int(ot.sync_offset(jnp.asarray(rx)))
    off = max(off, 0)
    aligned = rx[off:]
    n_chunks = -(-len(aligned) // 80)
    aligned = np.concatenate([aligned,
                              np.zeros(n_chunks * 80 - len(aligned),
                                       np.complex128)])
    got, _ = decode_aligned(jnp.asarray(aligned), n_chunks=n_chunks,
                            guard_bands=gb, modulation=ot.Modulation(mod))
    np.testing.assert_array_equal(np.asarray(got), expected)


def test_oracle_itself_decodes():
    data = bytes(range(60))
    tx = ot.encode(data, guard_bands=True, modulation=ot.Modulation.QPSK,
                   dtype=jnp.complex128)
    rx = np.asarray(ot.channel(tx, snr=30.0, key=jax.random.key(9)))
    out = oracle_decode(rx, True, "qpsk")
    assert bytes(out[16:76].tobytes()) == data
