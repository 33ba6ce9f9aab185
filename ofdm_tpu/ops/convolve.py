"""Linear convolution for the channel simulator.

The reference convolves the whole transmission with a 64-tap impulse response
via full-length FFTs (src/signals/mod.rs:219-237, src/channel.rs:45).  On an
accelerator a 64-tap kernel is cheaper as a direct convolution (fused MACs, no giant
FFT, exact linear — not circular — semantics), so that is the default; an
FFT path is kept for parity testing.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from .fft import fft, ifft


def convolve_direct(x: jnp.ndarray, h_real: jnp.ndarray) -> jnp.ndarray:
    """Full linear convolution of complex ``x`` (batched, last axis) with a
    real kernel ``h``.  Output length = T + K - 1, matching the reference."""
    squeeze = x.ndim == 1
    if squeeze:
        x = x[None, :]
    k = h_real.shape[-1]
    rd = jnp.float32 if x.dtype == jnp.complex64 else jnp.float64
    h = h_real.astype(rd)

    def conv1d(v):
        # XLA's conv primitive computes correlation; reverse the kernel to
        # obtain true convolution y[n] = sum_k h[k] x[n-k].
        lhs = v[:, None, :]
        rhs = h[::-1][None, None, :]
        out = jax.lax.conv_general_dilated(
            lhs, rhs, window_strides=(1,), padding=[(k - 1, k - 1)],
            dimension_numbers=("NCH", "OIH", "NCH"))
        return out[:, 0, :]

    out = jax.lax.complex(conv1d(jnp.real(x).astype(rd)),
                          conv1d(jnp.imag(x).astype(rd)))
    return out[0] if squeeze else out


def convolve_fft(x: jnp.ndarray, h: jnp.ndarray) -> jnp.ndarray:
    """FFT-based linear convolution, parity with src/signals/mod.rs:219-237."""
    n = x.shape[-1] + h.shape[-1] - 1
    xp = jnp.pad(x, (0, n - x.shape[-1]))
    hp = jnp.pad(h.astype(xp.dtype), (0, n - h.shape[-1]))
    return ifft(fft(xp, use_matmul=False) * fft(hp, use_matmul=False),
                use_matmul=False)
