"""transmitloop: periodic frame transmitter (realizes the reference's
examples/transmitloop.rs stub — it loaded the GIF bytestream then only
printed in a loop; here the loop actually emits frames).

Cycles through the GIF frames, encoding each and appending the IQ stream to
a rolling output file (or stdout-counted dry run) at a configurable period —
the software stand-in for a periodic radio sender."""

from __future__ import annotations

import argparse
import pathlib
import time

import numpy as np

import ofdm_tpu as ot
from ofdm_tpu.core.transfer import to_host
from ofdm_tpu.fec import reed_solomon as rs
from ofdm_tpu.io.iqfile import sig_to_bytes
from ofdm_tpu.obs.logging import set_up_logging
from ofdm_tpu.packets.gif import gif_to_bytestream

DEFAULT_GIF = "/root/reference/support/dancing_super_small.gif"


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--gif", default=DEFAULT_GIF)
    p.add_argument("--iterations", type=int, default=8)
    p.add_argument("--period", type=float, default=0.0, help="seconds between frames")
    p.add_argument("--out", default=None, help="append IQ stream to this file")
    p.add_argument("--modulation", default="qpsk",
                   choices=[m.value for m in ot.Modulation])
    args = p.parse_args(argv)

    log = set_up_logging("transmitloop")
    mod = ot.Modulation(args.modulation)
    _, frames = gif_to_bytestream(pathlib.Path(args.gif).read_bytes())

    # batch-encode all unique frames once; the loop just replays
    coded = np.stack([rs.encode_stream(f) for f in frames])
    tx = to_host(ot.encode(coded, guard_bands=True, modulation=mod))

    out_f = open(args.out, "ab") if args.out else None
    try:
        for i in range(args.iterations):
            frame = tx[i % len(frames)]
            if out_f is not None:
                out_f.write(sig_to_bytes(frame))
            log.info("sent frame %d (%d samples)", i, frame.size)
            if args.period:
                time.sleep(args.period)
    finally:
        if out_f is not None:
            out_f.close()
    return 0


if __name__ == "__main__":
    from ofdm_tpu.apps import run
    run(main)
