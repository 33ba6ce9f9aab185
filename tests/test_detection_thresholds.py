"""SNR behavior of the streaming detection gates.

decode_burst AND decode_continuous both gate on the normalized matched
filter (detection_rho=0.3; one statistic across all scanning paths, which
replaced an earlier PAR gate).  These sweeps
establish the gate's false-negative behavior down the SNR ladder and its
false-positive behavior on noise-only streams (the regime a live receiver
actually sees: examples/jetson_rx.rs:87-90 skip-and-continue).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import ofdm_tpu as ot
from ofdm_tpu.phy.streaming import decode_burst, decode_continuous

PAYLOAD = 64
MOD = ot.Modulation.QPSK


@pytest.fixture(scope="module")
def frame():
    rng = np.random.default_rng(11)
    data = rng.integers(0, 256, PAYLOAD, dtype=np.uint8)
    tx = np.asarray(ot.encode(data, guard_bands=True, modulation=MOD,
                              dtype=jnp.complex128))
    return data, tx


def _noisy_stream(rng, tx, offsets, T, snr_db):
    """Embed tx at offsets into white noise such that the per-sample SNR over
    the frame extent is snr_db."""
    sig_var = np.mean(np.abs(tx) ** 2)
    n_var = sig_var / 10 ** (snr_db / 10.0)
    s = np.sqrt(n_var / 2) * (rng.standard_normal(T)
                              + 1j * rng.standard_normal(T))
    for off in offsets:
        s[off:off + tx.shape[-1]] += tx
    return jnp.asarray(s)


@pytest.mark.parametrize("snr_db", [0.0, 5.0, 10.0, 30.0])
def test_burst_gate_detects_down_the_snr_ladder(frame, snr_db):
    """No false negatives at the default rho gate from 0 dB up (the gate's
    design point is ~-4 dB: rho ~= snr/(1+snr) at a true locking block)."""
    data, tx = frame
    rng = np.random.default_rng(int(snr_db) + 3)
    offsets = [500, 9000]
    stream = _noisy_stream(rng, tx, offsets, 16384, snr_db)
    found = decode_burst(stream, payload_len=PAYLOAD, guard_bands=True,
                         modulation=MOD)
    assert len(found) == len(offsets), \
        f"missed frames at {snr_db} dB: {[p for p, _, _ in found]}"
    if snr_db >= 30.0:   # decode (not just detect) must succeed when clean
        for _, p, _ in found:
            np.testing.assert_array_equal(p, data)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_burst_gate_no_false_positives_on_noise(frame, seed):
    _, tx = frame
    rng = np.random.default_rng(100 + seed)
    n_var = np.mean(np.abs(tx) ** 2)     # noise as loud as a frame would be
    s = np.sqrt(n_var / 2) * (rng.standard_normal(16384)
                              + 1j * rng.standard_normal(16384))
    found = decode_burst(jnp.asarray(s), payload_len=PAYLOAD,
                         guard_bands=True, modulation=MOD)
    assert found == [], f"false positives on noise: {[p for p, _, _ in found]}"


def test_burst_gate_margin_at_design_point(frame):
    """The rho statistic itself: a true locking block at 0 dB scores well
    above the 0.3 gate and pure noise scores well below it — the gate sits
    in a real margin, not on a knife edge."""
    from ofdm_tpu.config import DEFAULT_CONFIG as cfg
    from ofdm_tpu.phy.streaming import _scan_windows
    _, tx = frame
    rng = np.random.default_rng(42)
    flen = tx.shape[-1]
    stream = _noisy_stream(rng, tx, [1000], 2 * flen + 2048, 0.0)
    _, pars = _scan_windows(stream, n_win=2, stride=flen, cfg=cfg)
    assert float(np.max(np.asarray(pars))) > 0.4       # true block, 0 dB
    noise = _noisy_stream(rng, 0 * tx, [], 2 * flen + 2048, 0.0)
    _, pars_n = _scan_windows(noise, n_win=2, stride=flen, cfg=cfg)
    assert float(np.max(np.asarray(pars_n))) < 0.2     # noise-only


@pytest.mark.parametrize("snr_db", [0.0, 5.0, 30.0])
def test_continuous_gate_detects(frame, snr_db):
    data, tx = frame
    rng = np.random.default_rng(int(snr_db) + 7)
    offsets = [700]
    stream = _noisy_stream(rng, tx, offsets, 12288, snr_db)
    found = list(decode_continuous(stream, payload_len=PAYLOAD,
                                   guard_bands=True, modulation=MOD))
    assert len(found) == 1, f"rho gate missed the frame at {snr_db} dB"


@pytest.mark.parametrize("seed", [0, 1])
def test_continuous_gate_no_false_positives_on_noise(frame, seed):
    _, tx = frame
    rng = np.random.default_rng(200 + seed)
    n_var = np.mean(np.abs(tx) ** 2)
    s = np.sqrt(n_var / 2) * (rng.standard_normal(12288)
                              + 1j * rng.standard_normal(12288))
    found = list(decode_continuous(jnp.asarray(s), payload_len=PAYLOAD,
                                   guard_bands=True, modulation=MOD))
    assert found == []
