"""Measured BER of every shipped mapper vs the exact analytic Gray-QAM curve.

The reference's QAM arms are empty stubs (src/transmitter.rs:135-136), so the
constellations have no byte-parity oracle; these assertions pin their
decision boundaries to theory instead.  A wrong-by-one threshold (~2 dB)
moves BER by >2x at these operating points — far outside the tolerance band —
so a boundary regression cannot pass.

Methodology: symbol-level complex AWGN around the bare mapper
(modulate_bytes_packed -> noise at exact Es/N0 -> demodulate_symbols_packed).
This isolates the decision boundaries from the OFDM chain, whose
equalization/CFO stages are oracle-tested elsewhere.  Sample sizes put
>= 1500 expected errors at every point: 2-sigma of the estimate is < 6%,
against a +-20% acceptance band.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest

from ofdm_tpu.obs.ber_theory import ber_awgn, q_func, symbol_energy
from ofdm_tpu.phy.modulation import (BITS_PER_SYMBOL, Modulation,
                                     demodulate_symbols_packed,
                                     modulate_bytes_packed)

# (modulation, Es/N0 dB points) chosen so BER sits in ~2e-3 .. 3e-2:
# high enough to measure tightly, low enough that boundary errors dominate.
CASES = [
    (Modulation.BPSK, [4.0, 7.0]),
    (Modulation.QPSK, [7.0, 10.0]),
    (Modulation.QAM16, [12.0, 15.0]),
    (Modulation.QAM64, [18.0, 21.0]),
    (Modulation.QAM256, [24.0, 27.0]),
]

N_BYTES = 3 * (1 << 15)     # 98304 bytes = 786k bits; divisible by 3 so
                            # QAM64's 6-bit symbols tile bytes exactly


def _measure_ber(mod: Modulation, snr_db: float, seed: int) -> float:
    rng = np.random.default_rng(seed)
    data = rng.integers(0, 256, N_BYTES, dtype=np.uint8)
    syms = np.asarray(modulate_bytes_packed(jnp.asarray(data), mod,
                                            dtype=jnp.complex128))
    es = symbol_energy(mod)
    n0 = es / 10.0 ** (snr_db / 10.0)
    noise = math.sqrt(n0 / 2.0) * (rng.standard_normal(syms.shape)
                                   + 1j * rng.standard_normal(syms.shape))
    got = np.asarray(demodulate_symbols_packed(jnp.asarray(syms + noise), mod))
    errs = int(np.unpackbits(got ^ data).sum())
    return errs / (N_BYTES * 8)


@pytest.mark.parametrize("mod,snrs", CASES,
                         ids=[m.value for m, _ in CASES])
def test_ber_matches_analytic_gray_curve(mod, snrs):
    for snr_db in snrs:
        theory = ber_awgn(mod, snr_db)
        measured = _measure_ber(mod, snr_db, seed=int(snr_db * 10))
        assert 0.8 * theory < measured < 1.2 * theory, (
            f"{mod.value} @ {snr_db} dB Es/N0: measured BER {measured:.3e} "
            f"outside 20% of analytic {theory:.3e}")


def test_analytic_formula_sanity():
    """Pin the closed form itself to independently-known values."""
    # BPSK: Q(sqrt(2 Es/N0)); at 0 dB -> Q(sqrt(2)) ~= 0.0786
    assert abs(ber_awgn(Modulation.BPSK, 0.0) - q_func(math.sqrt(2))) < 1e-12
    # QPSK: per-bit Q(sqrt(Es/N0)) exactly (two independent BPSK axes)
    for s in (3.0, 6.0, 9.0):
        g = 10 ** (s / 10)
        assert abs(ber_awgn(Modulation.QPSK, s) - q_func(math.sqrt(g))) < 1e-12
    # QAM16 leading term: (3/4) Q(sqrt(Es/N0 / 5)) dominates at high SNR
    g = 10 ** (20 / 10)
    lead = 0.75 * q_func(math.sqrt(g / 5))
    assert abs(ber_awgn(Modulation.QAM16, 20.0) - lead) / lead < 0.02
    # monotone decreasing in SNR for every scheme
    for mod, _ in CASES:
        vals = [ber_awgn(mod, s) for s in (5, 10, 15, 20, 25)]
        assert all(a > b for a, b in zip(vals, vals[1:]))
