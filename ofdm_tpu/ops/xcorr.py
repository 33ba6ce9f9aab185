"""Cross-correlation and frame synchronization.

Two implementations with identical argmax/offset semantics:

- ``xcorr_fft``: the MATLAB-convention reference oracle (pad both inputs to
  2*len(a)-1, FFT(a)*conj(FFT(b)), IFFT, fftshift, argmax) replicating
  src/signals/mod.rs:186-217 exactly.  Used in tests and for API parity.
- ``sliding_correlation`` / ``locking_sync_offset``: the batched path.  The
  locking template is only 80 taps, so the correlation is a short-kernel
  convolution over the sample stream — O(80*N) fused multiply-accumulate
  work (or one banded-Toeplitz matmul) instead of three full-length FFTs.  The lag->offset arithmetic reproduces the
  reference's ``idxmax - ((len-1)/2 + 1)`` formula (src/receiver.rs:20-25):
  for a peak at lag k the returned offset is k - 1.
"""

from __future__ import annotations

from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np

from .fft import fft, ifft
from .shift import fft_shift


def locking_sync_quality(samples: jnp.ndarray, template: jnp.ndarray,
                         compute_dtype=None):
    """(offset, rho) for frame detection in continuous scanning.

    The reference always trusts the global argmax (src/receiver.rs:20-25);
    when scanning long streams with noise-only regions a detection gate is
    needed.  ``rho`` is the normalized matched filter maximized over lags
    >= 0: rho[L] = |c[L]|^2 / (E_template * E_window[L]), in [0, 1] by
    Cauchy-Schwarz — ~snr/(1+snr) at a true locking block, ~ln(T)/K on
    noise-only or data-only lags, and scale-free.  This is the SAME
    statistic that gates decode_burst (phy/streaming._scan_windows), so
    every streaming detection path shares one SNR-swept gate
    (tests/test_detection_thresholds.py); the previous peak-to-average
    power gate could be diluted by frame bodies sharing the window.
    The offset still comes from the correlation-power argmax like every
    sync path (windows past the stream end see zeros).
    """
    c = sliding_correlation(samples, template, compute_dtype=compute_dtype)
    k = template.shape[-1]
    t = samples.shape[-1]
    power = (jnp.real(c) ** 2 + jnp.imag(c) ** 2)[..., k - 1:]  # lags 0..T-1
    e_t = float(np.sum(np.abs(np.asarray(template)) ** 2))
    en = jnp.real(samples) ** 2 + jnp.imag(samples) ** 2
    en = jnp.pad(en, [(0, 0)] * (en.ndim - 1) + [(1, k)])
    cs = jnp.cumsum(en, axis=-1)
    e_w = cs[..., k:k + t] - cs[..., :t]
    rho = power / (e_t * e_w + 1e-30)
    return jnp.argmax(power, axis=-1) - 1, jnp.max(rho, axis=-1)


def xcorr_fft(a: jnp.ndarray, b: jnp.ndarray):
    """MATLAB-style linear cross-correlation, parity with src/signals/mod.rs:186-217.

    Returns (idxmax, cross) where cross has length 2*len(a)-1 and is
    fftshifted so index p corresponds to lag p - (len(a)-1).
    """
    a = jnp.asarray(a)
    b = jnp.asarray(b)
    pad_to = 2 * a.shape[-1] - 1
    ap = jnp.pad(a, (0, pad_to - a.shape[-1]))
    bp = jnp.pad(b, (0, pad_to - b.shape[-1]))
    cross = fft_shift(ifft(fft(ap, use_matmul=False)
                           * jnp.conj(fft(bp, use_matmul=False)),
                           use_matmul=False))
    idxmax = jnp.argmax(jnp.abs(cross) ** 2)
    return idxmax, cross


def sliding_correlation(samples: jnp.ndarray, template: jnp.ndarray,
                        compute_dtype=None) -> jnp.ndarray:
    """c[i] = sum_n samples[i - K + 1 + n] * conj(template[n]) computed for
    lags i-K+1 in [-(K-1), N-1] where K = len(template), N = samples length.

    Output index i corresponds to lag i - (K-1).  Batched over leading axes.
    Implemented as a real depthwise convolution pair (template conjugated),
    which XLA lowers to fused multiply-accumulate.
    """
    squeeze = samples.ndim == 1
    if squeeze:
        samples = samples[None, :]
    batch = samples.shape[:-1]
    samples = samples.reshape(-1, samples.shape[-1])
    k = template.shape[-1]
    rd = jnp.float32 if samples.dtype == jnp.complex64 else jnp.float64
    tr = jnp.real(template).astype(rd)
    ti = jnp.imag(template).astype(rd)

    # One 2-in/2-out channel conv computes the whole complex correlation:
    # (sr + j si) * conj(tr + j ti): re = sr*tr + si*ti ; im = si*tr - sr*ti.
    # XLA's conv is correlation (kernel not reversed), exactly the sliding
    # template match: out[i] = sum_j x[i-(k-1)+j] h[j] = c[lag = i-(k-1)].
    # compute_dtype=bfloat16 runs the MACs with bf16 inputs; the sync peak is very tolerant of bf16's ~8-bit mantissa (the argmax
    # compares well-separated correlation power levels).  Accumulation stays
    # f32 via preferred_element_type.
    cd = compute_dtype or rd
    lhs = jnp.stack([jnp.real(samples).astype(rd),
                     jnp.imag(samples).astype(rd)], axis=1)   # [B, 2, T]
    if _template_is_real(np.asarray(template)):
        # real template (the locking ramp): re/im each correlate with tr
        # alone — a grouped (depthwise) conv with HALF the MACs
        rhs = jnp.stack([tr[None], tr[None]])                  # [2, 1, k]
        out = jax.lax.conv_general_dilated(
            lhs.astype(cd), rhs.astype(cd), window_strides=(1,),
            padding=[(k - 1, k - 1)], feature_group_count=2,
            dimension_numbers=("NCH", "OIH", "NCH"),
            preferred_element_type=rd)
        out = out.reshape(*batch, 2, out.shape[-1])
        c = jax.lax.complex(out[..., 0, :], out[..., 1, :])
        return c[0] if squeeze else c
    rhs = jnp.stack([jnp.stack([tr, ti]),                      # out 0: re
                     jnp.stack([-ti, tr])])                    # out 1: im
    out = jax.lax.conv_general_dilated(
        lhs.astype(cd), rhs.astype(cd), window_strides=(1,),
        padding=[(k - 1, k - 1)],
        dimension_numbers=("NCH", "OIH", "NCH"),
        preferred_element_type=rd)
    out = jax.lax.complex(out[:, 0, :], out[:, 1, :])
    out = out.reshape(*batch, out.shape[-1])
    return out[0] if squeeze else out


@lru_cache(maxsize=None)
def _toeplitz_template(template_key, k: int, dtype_name: str):
    """Packed banded-Toeplitz of the conjugated template: W[512, 256] such
    that [frames_re | frames_im] @ W = [c_re | c_im] for 128 lags/frame."""
    t = np.asarray(_TEMPLATE_STORE[template_key])
    tr = np.zeros((256, 128))
    ti = np.zeros((256, 128))
    for b in range(128):
        tr[b:b + k, b] = t.real
        ti[b:b + k, b] = t.imag
    w = np.block([[tr, -ti], [ti, tr]])
    return w.astype(dtype_name)


@lru_cache(maxsize=None)
def _toeplitz_template_real(template_key, k: int, dtype_name: str):
    """Real-template banded Toeplitz Tr[256, 128]: frames_re @ Tr = c_re and
    frames_im @ Tr = c_im.  The locking template is a pure-real ramp
    (fft_shift only reorders — src/transmitter.rs:60-72), so the generic
    complex form's -ti/ti blocks are all zeros and HALF of every sync
    correlation matmul multiplies zeros; this form does half the MACs for
    identical results.  Also the one source of the sync kernel's template
    (kernels/sync_align.py)."""
    t = np.asarray(_TEMPLATE_STORE[template_key])
    tr = np.zeros((256, 128))
    for b in range(128):
        tr[b:b + k, b] = t.real
    return tr.astype(dtype_name)


def _template_is_real(tpl: np.ndarray) -> bool:
    return not np.iscomplexobj(tpl) or not np.any(tpl.imag)


_TEMPLATE_STORE: dict = {}


def sliding_correlation_matmul(samples: jnp.ndarray, template,
                               compute_dtype=None) -> jnp.ndarray:
    """c[lag] = sum_j samples[lag+j] * conj(template[j]) for lag in [0, T-1],
    as one matmul: stride-128 frames of 256 samples against a banded
    Toeplitz of the template ([.., 512] x [512, 256]).

    Requires len(template) <= 128.  samples: complex[B, T] (or [T]).
    This is the XLA sync path; the matmul states no precision, so an f32
    stream takes the backend's default (PERF.md says what that is on the
    GPU and why peak picking tolerates it).
    """
    squeeze = samples.ndim == 1
    if squeeze:
        samples = samples[None, :]
    b, t = samples.shape
    k = int(np.shape(template)[-1])
    assert k <= 128, "matmul correlation supports templates up to 128 taps"
    tpl = np.asarray(template)
    key = (tpl.tobytes(), k)
    _TEMPLATE_STORE[key] = tpl
    rd = jnp.float32 if samples.dtype == jnp.complex64 else jnp.float64
    cd = compute_dtype or rd

    n_frames = -(-t // 128)
    pad = n_frames * 128 + 256 - t
    x = jnp.pad(samples, ((0, 0), (0, pad)))
    blocks_re = jnp.real(x).astype(cd).reshape(b, -1, 128)
    blocks_im = jnp.imag(x).astype(cd).reshape(b, -1, 128)
    if _template_is_real(tpl):
        # real template: c_re = frames_re @ Tr, c_im = frames_im @ Tr —
        # half the MACs of the generic complex form (re/im stack on the
        # row axis so it is still ONE matmul)
        w = jnp.asarray(_toeplitz_template_real(key, k, jnp.dtype(cd).name))
        frames = jnp.concatenate([
            jnp.stack([blocks_re[:, :-1], blocks_im[:, :-1]], axis=1),
            jnp.stack([blocks_re[:, 1:], blocks_im[:, 1:]], axis=1),
        ], axis=-1)[:, :, :n_frames]                 # [b, 2, nf, 256]
        out = jnp.matmul(frames, w, preferred_element_type=rd)
        c = jax.lax.complex(out[:, 0].reshape(b, -1)[:, :t],
                            out[:, 1].reshape(b, -1)[:, :t])
        return c[0] if squeeze else c
    w = jnp.asarray(_toeplitz_template(key, k, jnp.dtype(cd).name))
    frames = jnp.concatenate([
        blocks_re[:, :-1], blocks_re[:, 1:],
        blocks_im[:, :-1], blocks_im[:, 1:]], axis=-1)[:, :n_frames]
    out = jnp.matmul(frames, w, preferred_element_type=rd)
    c = jax.lax.complex(out[..., :128].reshape(b, -1)[:, :t],
                        out[..., 128:].reshape(b, -1)[:, :t])
    return c[0] if squeeze else c


def sliding_correlation_fft(samples: jnp.ndarray, template: jnp.ndarray,
                            fft_len: int = 4096) -> jnp.ndarray:
    """Overlap-save sliding correlation: same output as
    ``sliding_correlation``'s lags >= 0 region (index i = lag i), computed
    with batched segment FFTs — O(log F) work per lag instead of O(K).

    samples: complex[B, T] -> complex[B, T] (lags 0..T-1; windows past the
    end see zeros, like the direct path).
    """
    squeeze = samples.ndim == 1
    if squeeze:
        samples = samples[None, :]
    b, t = samples.shape
    k = template.shape[-1]
    step = fft_len - k + 1
    n_seg = -(-t // step)
    pad_to = n_seg * step + k - 1
    x = jnp.pad(samples, ((0, 0), (0, pad_to - t)))
    # strided overlapping segments [B, n_seg, fft_len]
    starts = np.arange(n_seg) * step
    idx = starts[:, None] + np.arange(fft_len)[None, :]
    segs = x[:, idx]
    tf = jnp.conj(jnp.fft.fft(jnp.pad(template.astype(samples.dtype),
                                      (0, fft_len - k))))
    c = jnp.fft.ifft(jnp.fft.fft(segs, axis=-1) * tf, axis=-1)
    c = c[:, :, :step].reshape(b, n_seg * step)[:, :t]
    return c[0] if squeeze else c


def locking_sync_offset(samples: jnp.ndarray, template: jnp.ndarray,
                        compute_dtype=None) -> jnp.ndarray:
    """Frame-sync offset with reference semantics (src/receiver.rs:20-25).

    Equivalent to ``idxmax - ((len(cross)-1)/2 + 1)`` over the full xcorr: the
    reference's trailing zero-padded lags can never hold the strict maximum, so
    restricting the argmax to lags >= -(K-1) is exact.  Batched over leading axes.
    """
    if compute_dtype == "fft":
        c = sliding_correlation_fft(samples, template)
    elif compute_dtype == "conv" or (compute_dtype is not None
                                     and not isinstance(compute_dtype, str)
                                     and template.shape[-1] > 128):
        c = sliding_correlation(samples, template,
                                compute_dtype=None if compute_dtype == "conv"
                                else compute_dtype)
        k = template.shape[-1]
        power = jnp.real(c) ** 2 + jnp.imag(c) ** 2
        lag = jnp.argmax(power, axis=-1) - (k - 1)
        return lag - 1
    elif template.shape[-1] <= 128:
        # default: banded-Toeplitz matmul over lags >= 0 (negative lags
        # map to offsets < -1, which every consumer rejects anyway)
        cd = compute_dtype if not isinstance(compute_dtype, str) else None
        c = sliding_correlation_matmul(samples, np.asarray(template),
                                       compute_dtype=cd)
    else:
        c = sliding_correlation(samples, template)
        k = template.shape[-1]
        power = jnp.real(c) ** 2 + jnp.imag(c) ** 2
        lag = jnp.argmax(power, axis=-1) - (k - 1)
        return lag - 1
    power = jnp.real(c) ** 2 + jnp.imag(c) ** 2
    return jnp.argmax(power, axis=-1) - 1          # index == lag here
