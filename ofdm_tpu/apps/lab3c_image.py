"""lab3c_image: file-based tx/rx of the colorspace image payload
(rebuilds examples/lab3c_image.rs): ``--transmit`` writes the RS-coded image
frame as an fc32 IQ file; ``--receive`` decodes a (possibly captured) file
and renders the recovered 24x24 frame as a PNG."""

from __future__ import annotations

import argparse
import pathlib

import numpy as np

import ofdm_tpu as ot
from ofdm_tpu.core.transfer import to_host
from ofdm_tpu.fec import reed_solomon as rs
from ofdm_tpu.io.iqfile import read_iq, write_iq
from ofdm_tpu.obs.logging import set_up_logging
from ofdm_tpu.packets.colors import id_to_rgb

DEFAULT_IMAGE = "/root/reference/support/dancing.bytes"


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    g = p.add_mutually_exclusive_group(required=True)
    g.add_argument("--transmit", metavar="PATH")
    g.add_argument("--receive", metavar="PATH")
    p.add_argument("--image", default=DEFAULT_IMAGE)
    p.add_argument("--width", type=int, default=24)
    p.add_argument("--height", type=int, default=24)
    p.add_argument("--start", type=int, default=None)
    p.add_argument("--stop", type=int, default=None)
    p.add_argument("--out", default=None, help="recovered frame PNG path")
    p.add_argument("--modulation", default="qpsk",
                   choices=[m.value for m in ot.Modulation])
    args = p.parse_args(argv)

    log = set_up_logging("lab3c_image")
    mod = ot.Modulation(args.modulation)

    if args.transmit:
        raw = np.frombuffer(pathlib.Path(args.image).read_bytes(), np.uint8)
        coded = rs.encode_stream(raw)
        tx = to_host(ot.encode(coded, guard_bands=True, modulation=mod))
        write_iq(args.transmit, tx)
        log.info("wrote %d samples (%d-byte image, RS-coded %d) to %s",
                 tx.size, raw.size, coded.size, args.transmit)
        return 0

    samples = read_iq(args.receive)
    if args.start is not None or args.stop is not None:
        samples = samples[args.start or 0: args.stop]
    try:
        out = ot.decode(samples, guard_bands=True, modulation=mod)
    except ot.DecodeError as e:
        log.error("decode failed: %s", e)
        return 1
    decoded, ok = rs.decode_stream(out)
    if not ok:
        log.error("FEC uncorrectable")
        return 1
    n = args.width * args.height
    frame = decoded[:n]
    log.info("recovered %d-pixel frame", n)
    if args.out:
        from PIL import Image
        Image.fromarray(id_to_rgb(frame).reshape(args.height, args.width, 3),
                        "RGB").save(args.out)
        log.info("wrote %s", args.out)
    return 0


if __name__ == "__main__":
    from ofdm_tpu.apps import run
    run(main)
