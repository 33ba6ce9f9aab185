"""stream_bytes: precompute the "video over radio" IQ files
(rebuilds examples/stream_bytes.rs:15-42).

RS-encodes each GIF frame's colorspace bytes and writes ``tx_dance{i}.dat``
fc32 IQ files ready for loop transmission or replay through rx_stream.
"""

from __future__ import annotations

import argparse
import pathlib

import numpy as np

import ofdm_tpu as ot
from ofdm_tpu.fec import reed_solomon as rs
from ofdm_tpu.io.iqfile import write_iq
from ofdm_tpu.obs.logging import set_up_logging
from ofdm_tpu.packets.gif import gif_to_bytestream

DEFAULT_GIF = "/root/reference/support/dancing_super_small.gif"


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--gif", default=DEFAULT_GIF)
    p.add_argument("--out-dir", default="data")
    p.add_argument("--modulation", default="qpsk",
                   choices=[m.value for m in ot.Modulation])
    args = p.parse_args(argv)

    log = set_up_logging("stream_bytes")
    out_dir = pathlib.Path(args.out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)

    dims, frames = gif_to_bytestream(pathlib.Path(args.gif).read_bytes())
    log.info("gif %sx%s, %d frames", dims[0], dims[1], len(frames))

    mod = ot.Modulation(args.modulation)
    # One batched encode for all frames.
    from ofdm_tpu.core.transfer import to_host
    coded = np.stack([rs.encode_stream(f) for f in frames])
    tx = to_host(ot.encode(coded, guard_bands=True, modulation=mod))
    for i in range(tx.shape[0]):
        path = out_dir / f"tx_dance{i}.dat"
        write_iq(path, tx[i])
        log.info("wrote %s (%d samples)", path, tx.shape[1])
    return 0


if __name__ == "__main__":
    from ofdm_tpu.apps import run
    run(main)
