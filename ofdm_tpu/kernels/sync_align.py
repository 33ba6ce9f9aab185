"""Frame sync on the GPU: a Pallas kernel through Triton.

``decode_frame``'s XLA route finds each row's frame start with the
banded-Toeplitz correlation of ``ops/xcorr.py``: it materializes the
stride-128 frames at twice the stream, the correlation output and its
complex assembly, then reduces to an argmax.  This kernel reads the planar
stream once and keeps only running maxima; the aligned window is then one
XLA gather (``align_planes``) that XLA fuses into the decode tail's reads.

Grid (row, split): each row's lags are cut into blocks of ``LAG_ROWS * TILE``
lags and each program scans ``BLOCKS_PER_PROG`` consecutive blocks.  A block
is ``n_w`` dots ``[LAG_ROWS, TILE] x [TILE, TILE]`` per plane against slices
of the real Toeplitz template (``c[lag] = sum_j s[lag + j] * tpl[j]``,
``lag = base + TILE * row + lane``), then the power ``re^2 + im^2`` updates
an elementwise running maximum (strictly greater wins, so each position keeps
its earliest block).  The program writes its maximum and the first lag that
attains it; XLA takes the first split holding the row's maximum, which gives
``jnp.argmax``'s first-occurrence lag, and the reference offset
``clip(lag - 1, 0, T - need)`` (src/receiver.rs:20-25).

Samples at or past ``scan_len`` read as zero, so a bounded acquisition scan
(``search_window``) sees exactly the truncated stream the XLA route
correlates.  Only real templates of at most 128 taps (the locking ramp) take
this kernel; ``decode_frame`` routes anything else through XLA.  There is no
interpret-mode fallback outside the tests: on another backend the Triton
lowering refuses the call.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

# TF32 on the tensor cores, the precision the XLA route's f32 matmul gets
# on the GPU by default: peak picking compares correlation powers far apart
# next to TF32's ~1e-3 relative error.
PRECISION = jax.lax.Precision.DEFAULT
# [16 x 32] lag tiles, 4 blocks per program, 2 warps, one pipeline stage:
# larger blocks or more stages exceed the H100's shared memory at a config-2
# row; this was the fastest geometry tried there (PERF.md)
TILE = 32
LAG_ROWS = 16
BLOCKS_PER_PROG = 4
NUM_WARPS = 2
_NO_LAG = np.int32(2 ** 30)


def _kernel(x_ref, w_ref, peak_ref, lag_ref, *, n_w, blocks_per_prog,
            scan_len):
    ws = [w_ref[i * TILE:(i + 1) * TILE, :] for i in range(n_w)]
    lb = LAG_ROWS * TILE
    within = (jax.lax.broadcasted_iota(jnp.int32, (LAG_ROWS, TILE), 0) * TILE
              + jax.lax.broadcasted_iota(jnp.int32, (LAG_ROWS, TILE), 1))
    flat = jax.lax.broadcasted_iota(jnp.int32, (lb,), 0)
    first = pl.program_id(1) * blocks_per_prog

    def frames(plane, start):
        """[LAG_ROWS, TILE]: samples start + TILE * row + lane (zero past the
        scan)."""
        v = plgpu.load(x_ref.at[plane, pl.ds(start, lb)],
                       mask=start + flat < scan_len, other=0.0)
        return v.reshape(LAG_ROWS, TILE)

    def corr(plane, base):
        acc = pl.dot(frames(plane, base), ws[0], precision=PRECISION)
        for i in range(1, n_w):
            acc += pl.dot(frames(plane, base + i * TILE), ws[i],
                          precision=PRECISION)
        return acc

    def scan_block(j, carry):
        best, best_lag = carry
        base = (first + j) * lb
        cre = corr(0, base)
        cim = corr(1, base)
        lag = base + within
        power = jnp.where(lag < scan_len, cre * cre + cim * cim, -1.0)
        better = power > best
        return jnp.where(better, power, best), jnp.where(better, lag, best_lag)

    best, lags = jax.lax.fori_loop(
        0, blocks_per_prog, scan_block,
        (jnp.full((LAG_ROWS, TILE), -2.0, jnp.float32),
         jnp.zeros((LAG_ROWS, TILE), jnp.int32)))
    peak = jnp.max(best)
    peak_ref[...] = jnp.full((1,), peak)
    lag_ref[...] = jnp.full((1,), jnp.min(jnp.where(best == peak, lags,
                                                    _NO_LAG)))


def toeplitz_real(template) -> np.ndarray:
    """The [256, 128] real banded Toeplitz of ``template`` (ops/xcorr.py's
    single source of the sync matrix)."""
    from ..ops.xcorr import _TEMPLATE_STORE, _toeplitz_template_real
    tpl = np.asarray(template)
    key = (tpl.tobytes(), tpl.shape[-1])
    _TEMPLATE_STORE[key] = tpl
    return _toeplitz_template_real(key, tpl.shape[-1], "float32")


def supports(template) -> bool:
    """Whether the kernel handles this locking template."""
    from ..ops.xcorr import _template_is_real
    tpl = np.asarray(template)
    return tpl.shape[-1] <= 128 and _template_is_real(tpl)


def sync_offsets(planes: jnp.ndarray, template, need: int,
                 search_window: int | None = None, sym_len: int = 80,
                 interpret: bool = False) -> jnp.ndarray:
    """f32[R, 2, T] planar rows -> int32[R] sync offsets in [0, T - need].

    The offsets of ``rx.sync_offset`` on the complex stream, clipped like
    ``decode_frame`` clips them, except on near-ties between two peak lags,
    which the different summation order may resolve to the other, equally
    valid peak.  ``search_window`` limits the scan to the first
    ``search_window + sym_len`` samples, like ``decode_frame``'s XLA route.
    ``interpret=True`` runs the kernel in the Pallas interpreter (tests).
    """
    r, two, t = planes.shape
    assert two == 2 and t >= need, (planes.shape, need)
    assert supports(template), "the sync kernel needs a real template <= 128 taps"
    k = np.shape(template)[-1]
    scan_len = t if search_window is None else min(t, search_window + sym_len)
    n_w = -(-(TILE + k - 1) // TILE)
    n_blocks = -(-scan_len // (LAG_ROWS * TILE))
    bpp = min(BLOCKS_PER_PROG, n_blocks)
    splits = -(-n_blocks // bpp)
    # rows [0, n_w * TILE) x cols [0, TILE) of the 128-lag Toeplitz are the
    # same function tpl[i - b] for a TILE-lag block
    w = jnp.asarray(toeplitz_real(template)[:n_w * TILE, :TILE])
    peak, lag = pl.pallas_call(
        functools.partial(_kernel, n_w=n_w, blocks_per_prog=bpp,
                          scan_len=scan_len),
        grid=(r, splits),
        in_specs=[pl.BlockSpec((None, 2, t), lambda i, s: (i, 0, 0)),
                  pl.BlockSpec((n_w * TILE, TILE), lambda i, s: (0, 0))],
        out_specs=[pl.BlockSpec((None, 1), lambda i, s: (i, s)),
                   pl.BlockSpec((None, 1), lambda i, s: (i, s))],
        out_shape=[jax.ShapeDtypeStruct((r, splits), jnp.float32),
                   jax.ShapeDtypeStruct((r, splits), jnp.int32)],
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS,
                                             num_stages=1),
        interpret=interpret,
        name="sync_offsets",
    )(planes.astype(jnp.float32), w)
    # splits are in lag order and each keeps its first maximum, so the first
    # split holding the row's maximum holds the first lag that attains it
    best = jnp.argmax(peak, axis=1)
    lag = jnp.take_along_axis(lag, best[:, None], axis=1)[:, 0]
    return jnp.clip(lag - 1, 0, t - need)


def align_planes(planes: jnp.ndarray, offsets: jnp.ndarray,
                 need: int) -> jnp.ndarray:
    """f32[R, 2, T], int[R] -> f32[R, 2, need] windows at the offsets."""
    def take(row, off):
        return jax.lax.dynamic_slice(row, (jnp.zeros((), off.dtype), off),
                                     (2, need))
    return jax.vmap(take)(planes, offsets)


def sync_align(planes: jnp.ndarray, template, need: int,
               search_window: int | None = None, sym_len: int = 80,
               interpret: bool = False) -> jnp.ndarray:
    """f32[R, 2, T] -> f32[R, 2, need]: each row's window from its sync
    offset (``sync_offsets``), ready for ``rx.decode_planar_matrix``."""
    off = sync_offsets(planes, template, need, search_window=search_window,
                       sym_len=sym_len, interpret=interpret)
    return align_planes(planes, off, need)
