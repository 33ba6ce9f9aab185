"""obs/profiler.py's trace reduction: interval union, per-kernel summary,
and a CPU trace (no GPU plane) reducing to nothing."""

import jax
import jax.numpy as jnp
import pytest

from ofdm_tpu.obs import profiler


@pytest.mark.parametrize("intervals,want", [
    ([], 0),
    ([(0, 10)], 10),
    ([(0, 10), (20, 25)], 15),            # disjoint: a gap of 10
    ([(0, 10), (5, 12)], 12),             # overlapping
    ([(0, 10), (2, 4), (10, 11)], 11),    # nested, then touching
    ([(20, 25), (0, 10)], 15),            # unsorted
])
def test_busy_ns_is_the_union(intervals, want):
    assert profiler.busy_ns(intervals) == want


def test_kernel_summary_per_step():
    # two steps of [a 0-4, b 4-6], then a 4 ns gap before the second step
    events = [("a", 0, 4), ("b", 4, 2), ("a", 10, 4), ("b", 14, 2)]
    s = profiler.kernel_summary(events, n_steps=2, top=1)
    assert s["kernels"] == [("a", 4e-3, 1.0)]
    assert s["launches_per_step"] == 2.0
    assert s["busy_us_per_step"] == pytest.approx(6e-3)
    assert s["window_us_per_step"] == pytest.approx(8e-3)
    assert s["idle_share"] == pytest.approx(0.25)


def test_device_breakdown_of_a_cpu_trace_is_empty(tmp_path):
    f = jax.jit(lambda x: x @ x)
    x = jnp.ones((32, 32))
    f(x).block_until_ready()
    with profiler.trace(str(tmp_path)):
        f(x).block_until_ready()
    assert profiler.device_breakdown(str(tmp_path), n_steps=1) == {}
    with pytest.raises(AssertionError, match="no trace"):
        profiler.device_breakdown(str(tmp_path / "missing"), n_steps=1)
