"""monitor: live terminal dashboard for a running receive stream
(realizes the reference's TUI-monitor intent — examples/tui/ and
examples/monitor.rs are stubs).

Renders per-buffer decode status, BER, CFO estimate, channel magnitude stem
plot and the equalized constellation, refreshing in place.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np

import ofdm_tpu as ot
from ofdm_tpu.core.transfer import to_device, to_host
from ofdm_tpu.io.feed import SampleFeed, synthetic_captures
from ofdm_tpu.obs.plots import constellation, stem_plot


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--buffers", type=int, default=6)
    p.add_argument("--buffer-len", type=int, default=32768)
    p.add_argument("--msg-bytes", type=int, default=256)
    p.add_argument("--snr", type=float, default=25.0)
    p.add_argument("--interval", type=float, default=0.0)
    p.add_argument("--no-clear", action="store_true")
    args = p.parse_args(argv)

    import jax

    from ofdm_tpu.core.corpus import create_transmission_text
    data = create_transmission_text(args.msg_bytes, ecc=False)
    tx = to_host(ot.encode(data, guard_bands=True, modulation=ot.Modulation.QPSK))

    # Precompute all channel realizations before the capture thread starts,
    # so the producer thread stays host-only.
    txd = to_device(tx)
    frames = [to_host(ot.channel(txd, snr=args.snr, timing_error=True,
                                 key=jax.random.key(i)))
              for i in range(args.buffers)]

    source = synthetic_captures(args.buffers, 1, lambda i: frames[i],
                                args.buffer_len)

    with SampleFeed(source) as feed:
        for i, buf in enumerate(feed):
            t0 = time.perf_counter()
            try:
                # Deliberate host-parity `decode` (NOT decode_frame): the
                # dashboard wants the diagnostics dict (offset, f_delta, h_k,
                # constellation) and refreshes at human cadence, so its
                # blocking host round trip per buffer is irrelevant here —
                # serving paths use decode_frame/decode_regular instead.
                out, diag = ot.decode(buf, guard_bands=True,
                                      modulation=ot.Modulation.QPSK,
                                      return_diagnostics=True)
                ok = True
            except ot.DecodeError:
                ok = False
            dt = time.perf_counter() - t0

            if not args.no_clear:
                sys.stdout.write("\x1b[2J\x1b[H")
            print(f"=== ofdm_tpu monitor — buffer {i} ===")
            if not ok:
                print("decode FAILED — skipping buffer")
                continue
            n = min(len(out), len(data))
            a = ot.Analysis.new(data[:n], out[:n])
            print(f"decode ok in {dt * 1e3:.1f} ms | offset={diag['offset']} "
                  f"f_delta={float(diag['f_delta']):.5f} | "
                  f"errs={a.num_errs} ber={a.err_rate:.5f}")
            print("\n-- channel |h_k| --")
            print(stem_plot(np.abs(diag["h_k"]), width=80, height=12))
            print("\n-- equalized constellation --")
            print(constellation(diag["equalized"][:512], width=60, height=24))
            if args.interval:
                time.sleep(args.interval)
    return 0


if __name__ == "__main__":
    from ofdm_tpu.apps import run
    run(main)
