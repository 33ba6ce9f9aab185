"""lab3a: simulated text loopback (rebuilds examples/lab3a.rs:11-46).

Text corpus -> encode -> simulated channel (SNR 30, no CFO) -> decode -> BER
report and recovered-text printout, with npy debug taps of the tx/channeled
streams.
"""

from __future__ import annotations

import argparse

import jax

import ofdm_tpu as ot
from ofdm_tpu.core.corpus import create_transmission_text, decipher_transmission_text
from ofdm_tpu.obs import taps
from ofdm_tpu.obs.logging import set_up_logging


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--msg-bytes", type=int, default=400)
    p.add_argument("--snr", type=float, default=30.0)
    p.add_argument("--cfo", action="store_true", help="inject carrier frequency offset")
    p.add_argument("--guard-bands", action="store_true")
    p.add_argument("--ecc", action="store_true", help="Reed-Solomon framing")
    p.add_argument("--modulation", default="qpsk",
                   choices=[m.value for m in ot.Modulation])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--taps", action="store_true", help="write npy debug taps")
    args = p.parse_args(argv)

    log = set_up_logging("lab3a")
    if args.taps:
        taps.enable()

    mod = ot.Modulation(args.modulation)
    data = create_transmission_text(args.msg_bytes, args.ecc)
    log.info("payload: %d bytes (%s, ecc=%s)", len(data), mod.name, args.ecc)

    tx = ot.encode(data, guard_bands=args.guard_bands, modulation=mod)
    taps.tap("transmitted_3a", tx)
    log.info("transmitted %d samples", tx.shape[-1])

    rx = ot.channel(tx, snr=args.snr, timing_error=args.cfo,
                    key=jax.random.key(args.seed))
    taps.tap("channeled_3a", rx)

    try:
        out = ot.decode(rx, guard_bands=args.guard_bands, modulation=mod)
    except ot.DecodeError as e:
        log.error("decode failed: %s", e)
        return 1

    n = min(len(out), len(data))
    analysis = ot.Analysis.new(data[:n], out[:n])
    log.info("analysis: errs=%d block_errs=%d ber=%.6f",
             analysis.num_errs, analysis.num_block_errs, analysis.err_rate)

    text = decipher_transmission_text(args.msg_bytes, out, args.ecc)
    print(text if text is not None else "<decode failed: FEC uncorrectable>")
    return 0 if analysis.num_errs == 0 else 2


if __name__ == "__main__":
    from ofdm_tpu.apps import run
    run(main)
