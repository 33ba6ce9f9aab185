"""Host<->device transfer helpers.

``to_host`` / ``to_device`` are plain transfers of any dtype, complex
included; they keep one name for the callers that move decoder inputs and
diagnostics.  ``to_device_planar`` uploads a capture as float planes for the
planar entry points.
"""

from __future__ import annotations

import jax
import numpy as np


def to_host(x) -> np.ndarray:
    """Device array (any dtype, incl. complex) -> numpy on host."""
    return np.asarray(x)


def to_device(x, dtype=None) -> jax.Array:
    """numpy array -> device array (complex128 narrows to complex64 unless
    x64 is enabled, as ``jnp.asarray`` does)."""
    arr = np.asarray(x)
    if dtype is None:
        dtype = jax.dtypes.canonicalize_dtype(arr.dtype)
    return jax.device_put(arr.astype(dtype, copy=False))


def to_device_planar(x, pad_to_tiles: bool = True) -> jax.Array:
    """Host samples -> PLANAR device stream f32[..., 2, T'] for
    ``decode_frame_planar`` and ``streaming.decode_regular``.

    Accepts complex arrays or an (re, im) plane pair (what
    ``io.capture.IQFile.read_planar`` yields — fc32 captures ARE planes
    after deinterleave).  No complex array is built on either side.

    ``pad_to_tiles`` zero-pads T to a multiple of 128 plus one spare tile,
    the form the pre-tiled planar entry points reshape for free.
    """
    if isinstance(x, tuple):
        re, im = (np.asarray(v, np.float32) for v in x)
    else:
        arr = np.asarray(x)
        re = arr.real.astype(np.float32)
        im = (arr.imag if np.iscomplexobj(arr)
              else np.zeros_like(arr)).astype(np.float32)
    t = re.shape[-1]
    t_pad = ((-(-t // 128)) + 1) * 128 if pad_to_tiles else t
    if t_pad != t:
        pad = [(0, 0)] * (re.ndim - 1) + [(0, t_pad - t)]
        re = np.pad(re, pad)
        im = np.pad(im, pad)
    return jax.device_put(np.stack([re, im], axis=-2))
