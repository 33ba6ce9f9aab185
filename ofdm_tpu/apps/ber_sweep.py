"""ber_sweep: BER waterfall curves over SNR per modulation scheme.

The analysis tool the reference lacked: sweeps the simulated channel's SNR,
runs batched loopbacks entirely on the accelerator, and reports BER per
(modulation, SNR) as JSON plus a terminal waterfall plot.
"""

from __future__ import annotations

import argparse
import json
import math

import numpy as np

import ofdm_tpu as ot
from ofdm_tpu.obs.logging import set_up_logging


def measure_ber(mod: ot.Modulation, snr: float, *, batch: int, payload: int,
                guard_bands: bool, cfo: bool, seed: int) -> float:
    import jax
    rng = np.random.default_rng(seed)
    data = rng.integers(0, 256, (batch, payload), dtype=np.uint8)
    tx = ot.encode(data, guard_bands=guard_bands, modulation=mod)
    rx = ot.channel(tx, snr=snr, timing_error=cfo, key=jax.random.key(seed))
    nb = ot.n_data_blocks(payload, mod, guard_bands)
    out = ot.decode_frame(rx, n_blocks=nb, guard_bands=guard_bands,
                          modulation=mod)
    got = np.asarray(out)[:, 16:16 + payload]
    errs = np.unpackbits(np.bitwise_xor(got, data)).sum()
    return float(errs) / (data.size * 8)


def measure_ber_awgn(mod: ot.Modulation, snr_db: float, *, n_bytes: int,
                     seed: int) -> float:
    """Symbol-level AWGN BER of the bare mapper at exact Es/N0 — the
    decision-boundary measurement comparable to the analytic Gray curve
    (obs/ber_theory.py; asserted by tests/test_ber_theory.py)."""
    import jax.numpy as jnp

    from ofdm_tpu.obs.ber_theory import symbol_energy
    from ofdm_tpu.phy.modulation import (demodulate_symbols_packed,
                                         modulate_bytes_packed)
    rng = np.random.default_rng(seed)
    data = rng.integers(0, 256, n_bytes, dtype=np.uint8)
    syms = np.asarray(modulate_bytes_packed(jnp.asarray(data), mod))
    n0 = symbol_energy(mod) / 10.0 ** (snr_db / 10.0)
    noise = math.sqrt(n0 / 2.0) * (rng.standard_normal(syms.shape)
                                   + 1j * rng.standard_normal(syms.shape))
    got = np.asarray(demodulate_symbols_packed(
        jnp.asarray((syms + noise).astype(np.complex64)), mod))
    return float(np.unpackbits(got ^ data).sum()) / (n_bytes * 8)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--snrs", type=float, nargs="*",
                   default=[0, 5, 10, 15, 20, 25, 30])
    p.add_argument("--modulations", nargs="*",
                   default=["bpsk", "qpsk", "qam16", "qam64"])
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--payload", type=int, default=256)
    p.add_argument("--guard-bands", action="store_true", default=True)
    p.add_argument("--cfo", action="store_true")
    p.add_argument("--json", action="store_true", help="JSON only, no plot")
    p.add_argument("--awgn-theory", action="store_true",
                   help="symbol-level AWGN sweep with the analytic Gray-QAM "
                        "curve printed alongside (Es/N0 dB)")
    args = p.parse_args(argv)

    log = set_up_logging("ber_sweep")
    if args.awgn_theory:
        from ofdm_tpu.obs.ber_theory import ber_awgn
        results = {}
        for name in args.modulations:
            mod = ot.Modulation(name)
            rows = []
            for snr in args.snrs:
                meas = measure_ber_awgn(mod, snr, n_bytes=3 * (1 << 15),
                                        seed=int(snr * 10) + 7)
                theo = ber_awgn(mod, snr)
                rows.append({"snr": snr, "measured": meas, "theory": theo})
                log.info("%s @ %.0f dB Es/N0: measured %.3e  theory %.3e",
                         mod.name, snr, meas, theo)
            results[name] = rows
        print(json.dumps({"snrs": args.snrs, "awgn": results}))
        return 0
    results = {}
    for name in args.modulations:
        mod = ot.Modulation(name)
        curve = []
        for snr in args.snrs:
            ber = measure_ber(mod, snr, batch=args.batch, payload=args.payload,
                              guard_bands=args.guard_bands, cfo=args.cfo,
                              seed=int(snr * 10) + 7)
            curve.append(ber)
            log.info("%s @ %.0f dB: BER %.2e", mod.name, snr, ber)
        results[name] = curve

    print(json.dumps({"snrs": args.snrs, "ber": results}))
    if not args.json:
        # terminal waterfall: log10(BER) per curve
        floor = 1.0 / (args.batch * args.payload * 8)
        print("\nlog10(BER) (floor = %.1f):" % math.log10(floor))
        for name, curve in results.items():
            row = " ".join(
                f"{math.log10(max(b, floor)):6.2f}" for b in curve)
            print(f"  {name:6s} {row}")
        print("  snr    " + " ".join(f"{s:6.0f}" for s in args.snrs))
    return 0


if __name__ == "__main__":
    from ofdm_tpu.apps import run
    run(main)
