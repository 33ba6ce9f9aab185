"""lab3c: file-based tx/rx split (rebuilds examples/lab3c.rs:15-84).

``--transmit path.dat`` writes an fc32 IQ file (wire-compatible with UHD's
tx_samples_from_file — data/transmit.sh); ``--receive path.dat`` decodes a
(possibly hardware-captured) IQ file with optional --start/--stop slicing.
"""

from __future__ import annotations

import argparse

import ofdm_tpu as ot
from ofdm_tpu.core.corpus import create_transmission_text, decipher_transmission_text
from ofdm_tpu.io.iqfile import read_iq, write_iq
from ofdm_tpu.obs.logging import set_up_logging
from ofdm_tpu.obs.plots import stem_plot


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    g = p.add_mutually_exclusive_group(required=True)
    g.add_argument("--transmit", metavar="PATH")
    g.add_argument("--receive", metavar="PATH")
    p.add_argument("--start", type=int, default=None)
    p.add_argument("--stop", type=int, default=None)
    p.add_argument("--msg-bytes", type=int, default=500)
    p.add_argument("--modulation", default="bpsk",
                   choices=[m.value for m in ot.Modulation])
    p.add_argument("--no-ecc", action="store_true")
    p.add_argument("--plot", action="store_true")
    args = p.parse_args(argv)

    log = set_up_logging("lab3c")
    mod = ot.Modulation(args.modulation)
    ecc = not args.no_ecc

    if args.transmit:
        data = create_transmission_text(args.msg_bytes, ecc)
        from ofdm_tpu.core.transfer import to_host
        tx = to_host(ot.encode(data, guard_bands=True, modulation=mod))
        if args.plot:
            print(stem_plot(tx[:800]))
        write_iq(args.transmit, tx)
        log.info("wrote %d samples to %s", tx.size, args.transmit)
        return 0

    samples = read_iq(args.receive)
    if args.start is not None or args.stop is not None:
        samples = samples[args.start or 0: args.stop]
    log.info("read %d samples from %s", samples.size, args.receive)
    try:
        out = ot.decode(samples, guard_bands=True, modulation=mod)
    except ot.DecodeError as e:
        log.error("decode failed: %s", e)
        return 1

    sent = create_transmission_text(args.msg_bytes, ecc)
    n = min(len(out), len(sent))
    analysis = ot.Analysis.new(sent[:n], out[:n])
    log.info("analysis: errs=%d ber=%.6f", analysis.num_errs, analysis.err_rate)
    text = decipher_transmission_text(args.msg_bytes, out, ecc)
    print(text if text is not None else "<FEC uncorrectable>")
    return 0


if __name__ == "__main__":
    from ofdm_tpu.apps import run
    run(main)
