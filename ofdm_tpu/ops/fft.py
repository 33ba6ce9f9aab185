"""FFT engines.

Two interchangeable paths, both matching the reference's conventions
(forward FFT unnormalized, inverse scaled by 1/N — src/signals/mod.rs:41-58,
i.e. exactly numpy semantics):

1. ``jnp.fft.fft/ifft`` — XLA's generic FFT.
2. ``dft_matmul`` — the matmul path for the tiny per-symbol 64-point
   transforms: a DFT is just a matmul, and a batched [N, 64] x [64, 64]
   complex matmul is one real [N, 128] x [128, 128] product that fuses with
   neighboring elementwise work.

The complex product (xr + j xi)(Wr + j Wi) is packed as

    [xr xi] @ [[Wr, Wi], [-Wi, Wr]] = [xr@Wr - xi@Wi,  xr@Wi + xi@Wr]

giving a single 128-wide real matmul (lane-dimension aligned).
"""

from __future__ import annotations

from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np


@lru_cache(maxsize=None)
def _dft_matrix(n: int, inverse: bool) -> np.ndarray:
    k = np.arange(n)
    sign = 2j if inverse else -2j
    w = np.exp(sign * np.pi * np.outer(k, k) / n)
    if inverse:
        w /= n
    return w


@lru_cache(maxsize=None)
def _packed_dft_matrix(n: int, inverse: bool, dtype_name: str) -> np.ndarray:
    w = _dft_matrix(n, inverse)
    wr, wi = w.real, w.imag
    packed = np.block([[wr, wi], [-wi, wr]])
    return packed.astype(dtype_name)


def dft_matmul(x: jnp.ndarray, inverse: bool = False,
               precision=jax.lax.Precision.HIGHEST) -> jnp.ndarray:
    """DFT over the last axis via a packed real matmul.

    Matches ``jnp.fft.fft`` (forward, unnormalized) / ``jnp.fft.ifft``
    (inverse, 1/N) on the last axis for any leading batch shape.

    ``precision`` trades accuracy for speed: HIGHEST keeps ~f32 accuracy
    (default — channel estimation divides by these outputs); lower settings
    let the backend use reduced-precision inputs.
    """
    n = x.shape[-1]
    real_dtype = jnp.finfo(x.dtype).dtype.name if jnp.iscomplexobj(x) else x.dtype.name
    w = jnp.asarray(_packed_dft_matrix(n, inverse, real_dtype))
    xr = jnp.real(x)
    xi = jnp.imag(x)
    packed = jnp.concatenate([xr, xi], axis=-1)
    out = jnp.matmul(packed, w, precision=precision,
                     preferred_element_type=packed.dtype)
    return jax.lax.complex(out[..., :n], out[..., n:])


@lru_cache(maxsize=None)
def _packed_dft_select_matrix(n: int, bins: tuple, dtype_name: str) -> np.ndarray:
    w = _dft_matrix(n, inverse=False)[:, list(bins)]
    wr, wi = w.real, w.imag
    return np.block([[wr, wi], [-wi, wr]]).astype(dtype_name)


def dft_matmul_select(x: jnp.ndarray, bins: tuple,
                      precision=jax.lax.Precision.HIGHEST) -> jnp.ndarray:
    """Forward DFT over the last axis evaluated only at ``bins``.

    Output bin order follows ``bins``.  For the OFDM receive path this skips
    the guard bins entirely: a [.., 128] x [128, 2k] matmul instead of
    [.., 128] x [128, 128] plus a gather — the downstream equalize/demod then
    runs on the packed bins with no 64-bin intermediate.
    """
    n = x.shape[-1]
    k = len(bins)
    real_dtype = jnp.finfo(x.dtype).dtype.name if jnp.iscomplexobj(x) \
        else x.dtype.name
    w = jnp.asarray(_packed_dft_select_matrix(n, tuple(bins), real_dtype))
    packed = jnp.concatenate([jnp.real(x), jnp.imag(x)], axis=-1)
    out = jnp.matmul(packed, w, precision=precision,
                     preferred_element_type=packed.dtype)
    return jax.lax.complex(out[..., :k], out[..., k:])


@lru_cache(maxsize=None)
def _dft_select_planes(n: int, bins: tuple, dtype_name: str):
    w = _dft_matrix(n, inverse=False)[:, list(bins)]
    return (np.ascontiguousarray(w.real).astype(dtype_name),
            np.ascontiguousarray(w.imag).astype(dtype_name))


def dft_matmul_select_derot(x: jnp.ndarray, bins: tuple, omega: jnp.ndarray,
                            sample_offset: int = 0,
                            precision=jax.lax.Precision.HIGHEST) -> jnp.ndarray:
    """``dft_matmul_select`` with a per-row CFO derotation folded into the
    DFT matrix.

    Computes y[..., c, k] = sum_p x[..., c, p] * exp(-i*omega*(sample_offset
    + p)) * W[p, bins[k]] — i.e. the DFT of the CFO-derotated symbol — without
    ever materializing (or re-reading) a derotated copy of the sample stream.
    The within-symbol phasor phi[p] = exp(-i*omega*(sample_offset + p)) is a
    rank-1 row scaling of the DFT matrix, so it becomes a per-row batched
    matmul [..., C, 2n] x [..., 2n, 2k]; the per-row matrix is only
    2n x 2k f32 (53 KB at the 52-bin guard-band shape) vs the full
    sample stream, removing the full-stream elementwise derotate pass of the
    aligned decode.  The remaining per-CHUNK phase exp(-i*omega*c*sym_len) is
    NOT applied here — the caller multiplies the (small) bin tensor by it,
    where it fuses into the equalizer.

    ``omega`` has the shape of ``x``'s batch dims (x.shape[:-2]).
    Mathematically identical to derotate-then-``dft_matmul_select``; results
    agree to f32 rounding (reduction order differs), not bitwise.
    """
    n = x.shape[-1]
    k = len(bins)
    real_dtype = jnp.finfo(x.dtype).dtype.name if jnp.iscomplexobj(x) \
        else x.dtype.name
    top, bot = _derot_select_matrix(n, tuple(bins), omega, sample_offset,
                                    real_dtype)
    wp = jnp.concatenate([top, bot], axis=-2)              # [..., 2n, 2k]
    packed = jnp.concatenate([jnp.real(x), jnp.imag(x)], axis=-1)
    out = jnp.matmul(packed, wp, precision=precision,
                     preferred_element_type=packed.dtype)
    return jax.lax.complex(out[..., :k], out[..., k:])


def _derot_select_matrix(n: int, bins: tuple, omega: jnp.ndarray,
                         sample_offset: int, dtype):
    """Per-row derotated DFT matrix halves for the planar/packed products.

    Returns (wp_top[..., n, 2k], wp_bot[..., n, 2k]) such that the packed
    product is  concat(xr, xi) @ concat(top, bot, axis=-2)  and the planar
    product is  xr @ top + xi @ bot  — same matrix, split at row n.
    """
    wr, wi = _dft_select_planes(n, tuple(bins), dtype)
    wr = jnp.asarray(wr)
    wi = jnp.asarray(wi)
    p_idx = jnp.arange(n, dtype=wr.dtype) + wr.dtype.type(sample_offset)
    ang = omega[..., None].astype(wr.dtype) * p_idx        # [..., n]
    cr = jnp.cos(ang)[..., :, None]                        # [..., n, 1]
    ci = -jnp.sin(ang)[..., :, None]
    vr = cr * wr - ci * wi                                 # [..., n, k]
    vi = cr * wi + ci * wr
    top = jnp.concatenate([vr, vi], axis=-1)               # [..., n, 2k]
    bot = jnp.concatenate([-vi, vr], axis=-1)
    return top, bot


def dft_matmul_select_derot_planar(xr: jnp.ndarray, xi: jnp.ndarray,
                                   bins: tuple, omega: jnp.ndarray,
                                   sample_offset: int = 0,
                                   precision=jax.lax.Precision.HIGHEST
                                   ) -> jnp.ndarray:
    """``dft_matmul_select_derot`` fed by separate real/imag planes.

    xr, xi: f32[..., C, n] — e.g. the planes of a planar aligned stream, so
    no complex64 aligned stream is ever materialized between alignment and
    the DFT.  The packed [.., 2n] x [2n, 2k] product becomes
    ``xr @ top + xi @ bot`` — two K=n matmuls summed instead of one K=2n
    matmul: identical math and total MACs, but the K-reduction splits at n,
    so results agree with the packed form to f32 rounding rather than
    bitwise (same acceptance standard as the matrix-derot fold itself;
    byte equality at operating SNRs is gated by tests/test_decode_options.py).
    """
    n = xr.shape[-1]
    k = len(bins)
    top, bot = _derot_select_matrix(n, tuple(bins), omega, sample_offset,
                                    xr.dtype.name)
    out = (jnp.matmul(xr, top, precision=precision,
                      preferred_element_type=xr.dtype)
           + jnp.matmul(xi, bot, precision=precision,
                        preferred_element_type=xi.dtype))
    return jax.lax.complex(out[..., :k], out[..., k:])


@lru_cache(maxsize=None)
def _packed_idft_rows_matrix(n: int, bins: tuple, dtype_name: str) -> np.ndarray:
    w = _dft_matrix(n, inverse=True)[list(bins), :]        # [k, n]
    wr, wi = w.real, w.imag
    return np.block([[wr, wi], [-wi, wr]]).astype(dtype_name)   # [2k, 2n]


def idft_matmul_rows(x: jnp.ndarray, bins: tuple, n: int,
                     precision=jax.lax.Precision.HIGHEST) -> jnp.ndarray:
    """Inverse DFT (1/N-scaled) of a spectrum nonzero only at ``bins``.

    ``x``: complex[..., k] bin values (order follows ``bins``) ->
    complex[..., n] time samples.  The transmit-side dual of
    ``dft_matmul_select``: with guard bands on, an OFDM block has only 52 of
    64 bins populated, so the per-symbol IFFT is a packed
    [.., 2k] x [2k, 2n] real matmul — the guard bins are never scattered or
    multiplied (cf. reference scatter + full IFFT, src/transmitter.rs:144-181).
    """
    k = len(bins)
    assert x.shape[-1] == k
    real_dtype = jnp.finfo(x.dtype).dtype.name if jnp.iscomplexobj(x) \
        else x.dtype.name
    w = jnp.asarray(_packed_idft_rows_matrix(n, tuple(bins), real_dtype))
    packed = jnp.concatenate([jnp.real(x), jnp.imag(x)], axis=-1)
    out = jnp.matmul(packed, w, precision=precision,
                     preferred_element_type=packed.dtype)
    return jax.lax.complex(out[..., :n], out[..., n:])


@lru_cache(maxsize=None)
def _packed_idft_rows_cp_matrix(n: int, bins: tuple, cp_len: int,
                                dtype_name: str) -> np.ndarray:
    w = _packed_idft_rows_matrix(n, bins, dtype_name)      # [2k, 2n]
    re, im = w[:, :n], w[:, n:]
    re_cp = np.concatenate([re[:, n - cp_len:], re], axis=1)
    im_cp = np.concatenate([im[:, n - cp_len:], im], axis=1)
    return np.ascontiguousarray(np.concatenate([re_cp, im_cp], axis=1))


def idft_matmul_rows_cp(x: jnp.ndarray, bins: tuple, n: int, cp_len: int,
                        precision=jax.lax.Precision.HIGHEST) -> jnp.ndarray:
    """``idft_matmul_rows`` with the cyclic prefix folded into the matrix.

    complex[..., k] bins -> complex[..., cp_len + n] time samples where the
    first cp_len samples repeat the block tail.  The CP columns are exact
    copies of the corresponding time-sample columns, so every output element
    is the SAME dot product as the concat formulation — bitwise identical —
    but the [..., cp] gather + concat pass over the full sample stream
    disappears (the matmul writes prefixed blocks directly).  ~cp/n more
    MACs, which is noise next to the saved memory pass.
    """
    k = len(bins)
    assert x.shape[-1] == k
    real_dtype = jnp.finfo(x.dtype).dtype.name if jnp.iscomplexobj(x) \
        else x.dtype.name
    w = jnp.asarray(_packed_idft_rows_cp_matrix(n, tuple(bins), cp_len,
                                                real_dtype))
    packed = jnp.concatenate([jnp.real(x), jnp.imag(x)], axis=-1)
    out = jnp.matmul(packed, w, precision=precision,
                     preferred_element_type=packed.dtype)
    m = n + cp_len
    return jax.lax.complex(out[..., :m], out[..., m:])


def fft(x: jnp.ndarray, use_matmul: bool | None = None) -> jnp.ndarray:
    """Forward FFT on the last axis, unnormalized (reference/rustfft semantics)."""
    if _should_use_matmul(x, use_matmul):
        return dft_matmul(x, inverse=False)
    return jnp.fft.fft(x, axis=-1)


def ifft(x: jnp.ndarray, use_matmul: bool | None = None) -> jnp.ndarray:
    """Inverse FFT on the last axis, scaled by 1/N (src/signals/mod.rs:49-58)."""
    if _should_use_matmul(x, use_matmul):
        return dft_matmul(x, inverse=True)
    return jnp.fft.ifft(x, axis=-1)


def _should_use_matmul(x: jnp.ndarray, use_matmul: bool | None) -> bool:
    if use_matmul is not None:
        return use_matmul
    # Default: matmul path for small transforms (the 64-pt OFDM symbol case);
    # generic FFT for long transforms where O(n log n) wins.
    return x.shape[-1] <= 256
