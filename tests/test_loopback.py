"""End-to-end loopback integration tests (the lab3a/lab3b paths).

These mirror the reference's layered fake-path strategy (SURVEY.md section 4):
the simulated channel stands in for the radio link, and BER via Analysis is
the gate — but unlike the reference we assert thresholds.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import ofdm_tpu as ot

DATA = (b"I met a traveller from an antique land, who said... " * 12)[:400]
C128 = jnp.complex128


def _loop(data, gb, mod, cfo, snr=30.0, key=1, dtype=C128):
    tx = ot.encode(data, guard_bands=gb, modulation=mod, dtype=dtype)
    rx = ot.channel(tx, snr=snr, timing_error=cfo, key=jax.random.key(key))
    out = ot.decode(rx, guard_bands=gb, modulation=mod)
    return ot.Analysis.new(np.frombuffer(data, np.uint8), out)


@pytest.mark.parametrize("gb", [False, True])
@pytest.mark.parametrize("mod", [ot.Modulation.BPSK, ot.Modulation.QPSK,
                                 ot.Modulation.QAM16])
@pytest.mark.parametrize("cfo", [False, True])
def test_zero_errors_at_snr30(gb, mod, cfo):
    a = _loop(DATA, gb, mod, cfo)
    assert a.num_errs == 0, a


@pytest.mark.parametrize("gb,cfo", [(False, False), (True, False), (True, True)])
def test_qam64_at_snr45(gb, cfo):
    # 64QAM needs more SNR than the lab default (outer points sit ~7x the
    # pilot amplitude, so pilot-phase jitter scales up with the radius); clean
    # at 45 dB.  With CFO the dense constellation additionally needs pilot
    # tracking (guardbands on) to absorb the residual frequency error.
    a = _loop(DATA, gb, ot.Modulation.QAM64, cfo, snr=45.0)
    assert a.num_errs == 0, a


def test_qam64_near_ber_floor_at_snr30():
    a = _loop(DATA, False, ot.Modulation.QAM64, False, snr=30.0)
    assert a.err_rate < 0.02, a


def test_float32_pipeline_decodes_clean():
    # The production dtype: complex64 end-to-end.
    a = _loop(DATA, True, ot.Modulation.QPSK, True, dtype=jnp.complex64)
    assert a.num_errs == 0, a


def test_short_input_raises():
    with pytest.raises(ot.DecodeError):
        ot.decode(jnp.asarray(np.zeros(400, np.complex128) +
                              np.r_[np.asarray(ot.encode(b"x", dtype=C128))[:400]]))


def test_decode_failure_on_garbage():
    rng = np.random.default_rng(0)
    noise = rng.standard_normal(2000) + 1j * rng.standard_normal(2000)
    try:
        out = ot.decode(jnp.asarray(noise))
        # garbage header -> absurd packet_length -> capped payload; any
        # non-crash outcome is acceptable (reference skips failed frames)
        assert out is not None
    except ot.DecodeError:
        pass


def test_cfo_aliasing_boundary_documented():
    """CFO draws near u=1 push the preamble phase drift to ~pi, where the
    Schmidl-Cox angle estimate aliases — a limitation the reference shares
    (src/channel.rs:50-54 comments that large f_delta "will roll over outside
    what shmidl cox can handle").  key=0 draws u=0.970: without pilot tones
    the residual CFO error accumulates and corrupts the frame; with pilot
    tracking (guardbands on) the per-block phase correction recovers it."""
    bad = _loop(DATA, False, ot.Modulation.QPSK, True, key=0)
    assert bad.num_errs > 0  # documented failure mode, parity with reference
    good = _loop(DATA, True, ot.Modulation.QPSK, True, key=0)
    assert good.num_errs == 0, good


def test_coherent_cfo_estimator_survives_aliasing_boundary():
    """cfo_estimator="coherent" (angle of the complex-averaged lag product,
    the production default on decode_frame/streaming: near the per-sample
    wrap the reference estimator loses whole frames, coherent none) recovers
    the u=0.970 draw that breaks the reference's per-sample-angle mean."""
    tx = ot.encode(DATA, guard_bands=False, modulation=ot.Modulation.QPSK,
                   dtype=C128)
    rx = ot.channel(tx, snr=30.0, timing_error=True, key=jax.random.key(0))
    nb = ot.n_data_blocks(len(DATA), ot.Modulation.QPSK, False)
    ref = ot.decode_frame(rx, n_blocks=nb, modulation=ot.Modulation.QPSK,
                          cfo_estimator="reference")
    coh = ot.decode_frame(rx, n_blocks=nb, modulation=ot.Modulation.QPSK,
                          cfo_estimator="coherent")
    expected = np.frombuffer(DATA, np.uint8)
    assert (np.asarray(ref)[16:16 + len(DATA)] != expected).sum() > 0
    np.testing.assert_array_equal(np.asarray(coh)[16:16 + len(DATA)], expected)


def test_snr_sweep_monotone_bpsk():
    """BER should be (weakly) monotone decreasing with SNR."""
    total_bits = len(DATA) * 8
    rates = []
    for snr in (-5.0, 5.0, 30.0):
        errs = 0
        for key in range(3):
            tx = ot.encode(DATA, dtype=C128)
            rx = ot.channel(tx, snr=snr, key=jax.random.key(key))
            try:
                out = ot.decode(rx)
                if len(out) != len(DATA):
                    errs += total_bits  # header destroyed: count as total loss
                else:
                    errs += ot.Analysis.new(np.frombuffer(DATA, np.uint8), out).num_errs
            except ot.DecodeError:
                errs += total_bits
        rates.append(errs)
    assert rates[-1] == 0
    assert rates[0] >= rates[-1]


def test_diagnostics_taps():
    tx = ot.encode(DATA, guard_bands=True, modulation=ot.Modulation.QPSK, dtype=C128)
    rx = ot.channel(tx, snr=30.0, timing_error=True, key=jax.random.key(5))
    out, diag = ot.decode(rx, guard_bands=True, modulation=ot.Modulation.QPSK,
                          return_diagnostics=True)
    assert diag["h_k"].shape == (64,)
    assert diag["f_delta"] >= 0
    assert diag["offset"] > 0
    assert diag["equalized"].ndim == 1


def test_cfo_estimate_accuracy():
    # Inject a known CFO via the channel's mechanism and check the receiver's
    # estimate: f_delta = pi*u/80 for u~U(0,1), estimate should match ~1e-3.
    tx = ot.encode(DATA, dtype=C128)
    rx = ot.channel(tx, snr=60.0, timing_error=True, key=jax.random.key(11))
    _, diag = ot.decode(rx, return_diagnostics=True)
    u = jax.random.uniform(jax.random.split(jax.random.key(11))[0], (),
                           dtype=jnp.float64)
    true_fd = float(jnp.pi * u / 80.0)
    assert abs(diag["f_delta"] - true_fd) / true_fd < 0.05
