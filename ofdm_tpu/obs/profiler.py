"""Profiler hooks: jax.profiler traces around pipeline sections.

The device-side equivalent of the reference's ad-hoc Instant timing
(src/signals/mod.rs:502-508) and fern debug spans: wrap any section in
``trace("name")`` to capture a TensorBoard-compatible trace, or use
``timed`` for wall-clock spans logged through the standard logger.
``device_breakdown`` reduces a captured trace to per-kernel device time and
each GPU's idle share.
"""

from __future__ import annotations

import collections
import contextlib
import glob
import logging
import os
import time

log = logging.getLogger("ofdm_tpu.profiler")


@contextlib.contextmanager
def trace(log_dir: str = "/tmp/ofdm_tpu_trace"):
    """Capture a jax profiler trace of the enclosed block."""
    import jax

    jax.profiler.start_trace(log_dir)
    try:
        yield log_dir
    finally:
        jax.profiler.stop_trace()


@contextlib.contextmanager
def timed(name: str):
    """Wall-clock span logged at DEBUG (blocks on async device work)."""
    import jax

    t0 = time.perf_counter()
    try:
        yield
    finally:
        try:
            jax.effects_barrier()
        except Exception:
            pass
        log.debug("%s: %.3f ms", name, (time.perf_counter() - t0) * 1e3)


@contextlib.contextmanager
def annotate(name: str):
    """Named region visible in profiler traces (TraceAnnotation)."""
    import jax

    with jax.profiler.TraceAnnotation(name):
        yield


def busy_ns(intervals) -> int:
    """Length of the union of [start, end) intervals."""
    total, end = 0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def kernel_summary(events, n_steps: int, top: int = 10) -> dict:
    """Reduce one device's kernel events ``(name, start_ns, duration_ns)``
    over ``n_steps`` steps: the ``top`` kernels by time (us per step and
    launches per step), busy and window time per step (window: first start
    to last end) and the idle share 1 - busy / window."""
    by, count = collections.Counter(), collections.Counter()
    for name, _, dur in events:
        by[name] += dur
        count[name] += 1
    spans = [(s, s + d) for _, s, d in events]
    window = max(e for _, e in spans) - min(s for s, _ in spans) if spans else 0
    busy = busy_ns(spans)
    return {
        "kernels": [(name, ns / n_steps / 1e3, count[name] / n_steps)
                    for name, ns in by.most_common(top)],
        "launches_per_step": len(events) / n_steps,
        "busy_us_per_step": busy / n_steps / 1e3,
        "window_us_per_step": window / n_steps / 1e3,
        "idle_share": 1.0 - busy / window if window else 0.0,
    }


def device_breakdown(trace_dir: str, n_steps: int, top: int = 10) -> dict:
    """{GPU plane name: kernel_summary} for a jax.profiler trace in
    ``trace_dir`` that covered ``n_steps`` steps; kernel events are those
    on each GPU's stream lines.  Empty when the trace holds no GPU."""
    from jax.profiler import ProfileData
    paths = glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"),
                      recursive=True)
    assert paths, f"no trace under {trace_dir}"
    out = {}
    for plane in ProfileData.from_file(max(paths, key=os.path.getmtime)).planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        events = [(e.name, e.start_ns, e.duration_ns)
                  for line in plane.lines if "Stream" in line.name
                  for e in line.events]
        out[plane.name] = kernel_summary(events, n_steps, top)
    return out
