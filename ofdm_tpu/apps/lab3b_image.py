"""lab3b_image: image-over-radio loopback (rebuilds examples/lab3b_image.rs).

Transmits the reference's ``dancing.bytes`` colorspace image through the
simulated channel with guardbands + RS ECC + CFO, decodes it, and renders the
recovered frame (PNG file or terminal preview instead of a minifb window).
"""

from __future__ import annotations

import argparse
import pathlib

import jax
import numpy as np

import ofdm_tpu as ot
from ofdm_tpu.fec import reed_solomon as rs
from ofdm_tpu.obs.logging import set_up_logging
from ofdm_tpu.packets.colors import id_to_rgb

DEFAULT_IMAGE = "/root/reference/support/dancing.bytes"


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--image", default=DEFAULT_IMAGE, help="colorspace .bytes file")
    p.add_argument("--width", type=int, default=24)
    p.add_argument("--height", type=int, default=24)
    p.add_argument("--snr", type=float, default=25.0)
    p.add_argument("--out", default=None, help="write recovered frame as PNG")
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)

    log = set_up_logging("lab3b_image")
    raw = np.frombuffer(pathlib.Path(args.image).read_bytes(), np.uint8)
    coded = rs.encode_stream(raw)
    log.info("image %d bytes -> %d RS-coded", raw.size, coded.size)

    tx = ot.encode(coded, guard_bands=True, modulation=ot.Modulation.QPSK)
    rx = ot.channel(tx, snr=args.snr, timing_error=True,
                    key=jax.random.key(args.seed))
    out = ot.decode(rx, guard_bands=True, modulation=ot.Modulation.QPSK)

    decoded, ok = rs.decode_stream(out)
    if not ok:
        log.error("FEC uncorrectable")
        return 1
    recovered = decoded[: raw.size]
    analysis = ot.Analysis.new(raw, recovered)
    log.info("analysis (post-FEC): errs=%d ber=%.6f",
             analysis.num_errs, analysis.err_rate)

    if args.out:
        from PIL import Image
        rgb = id_to_rgb(recovered).reshape(args.height, args.width, 3)
        Image.fromarray(rgb, "RGB").save(args.out)
        log.info("wrote %s", args.out)
    return 0 if analysis.num_errs == 0 else 2


if __name__ == "__main__":
    from ofdm_tpu.apps import run
    run(main)
