"""lab3b: simulated loopback with carrier-frequency offset
(rebuilds examples/lab3b.rs — lab3a's pipeline with timing_error on,
exercising the Schmidl-Cox CFO path)."""

from __future__ import annotations

from . import lab3a


def main(argv=None):
    argv = list(argv) if argv is not None else []
    if "--cfo" not in argv:
        argv.append("--cfo")
    return lab3a.main(argv)


if __name__ == "__main__":
    from ofdm_tpu.apps import run
    run(main)
