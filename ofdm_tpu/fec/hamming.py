"""Hamming(7,4) forward error correction — the north-star on-device codec.

The reference README claims "Error Correction with Hamming Codes" but actually
ships Reed-Solomon (README.md:11 vs src/utils.rs:97-137); BASELINE.json's
north star asks for a real Hamming(7,4).

Layout (this framework's spec):
- each byte splits into two nibbles, low nibble first (LSB-first, consistent
  with the modem bit order of src/utils.rs:21-27),
- each nibble d0..d3 maps to the systematic codeword [d0 d1 d2 d3 p0 p1 p2]
  with p = d @ P mod 2 (G = [I4 | P], H = [P^T | I3]),
- codeword bits are concatenated LSB-first and packed into bytes, zero-padded
  to a byte boundary.

Corrects any single bit error per 7-bit codeword.

Formulation: both directions run ENTIRELY as elementwise uint8 bit math in
a codeword-SoA layout — no 8x bool bit expansion and no [..., 7] minor-axis
reshapes; the work is elementwise on [..., n_code/8]-shaped planes.
7-bit codewords pack 8-to-7-bytes, so the byte stream reshapes losslessly to
[..., G, 7] groups and every codeword extraction / syndrome / correction /
nibble repack is a static-shape elementwise expression that fuses into the
surrounding modem graph (phy/streaming.py fuses decode into the demod
dispatch; phy/tx.py encode_hamming fuses encode into the modulator).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

# Parity generator P (4x3): p = d @ P mod 2.  G = [I4 | P], H = [P^T | I3].
# Kept for documentation/tests; the kernels below hard-code the same algebra
# as bit expressions (syndrome s = H @ c, flip position from s).
_P = np.array([[1, 1, 0],
               [1, 0, 1],
               [0, 1, 1],
               [1, 1, 1]], dtype=np.uint8)
_G = np.concatenate([np.eye(4, dtype=np.uint8), _P], axis=1)          # 4x7
_H = np.concatenate([_P.T, np.eye(3, dtype=np.uint8)], axis=1)        # 3x7


def encoded_len(n_bytes: int) -> int:
    """Encoded byte count for ``n_bytes`` of data: ceil(n*14/8)."""
    return -(-n_bytes * 14 // 8)


def _one(x):
    return x & jnp.uint8(1)


def encode(data: jnp.ndarray) -> jnp.ndarray:
    """uint8[..., n] -> uint8[..., ceil(n*14/8)] Hamming(7,4)-coded stream."""
    data = data.astype(jnp.uint8)
    n = data.shape[-1]
    # nibble stream, low nibble first: [..., 2n]
    nib = jnp.stack([data & jnp.uint8(15), data >> jnp.uint8(4)],
                    axis=-1).reshape(*data.shape[:-1], 2 * n)
    d0, d1 = _one(nib), _one(nib >> jnp.uint8(1))
    d2, d3 = _one(nib >> jnp.uint8(2)), _one(nib >> jnp.uint8(3))
    p0, p1, p2 = d0 ^ d1 ^ d3, d0 ^ d2 ^ d3, d1 ^ d2 ^ d3
    v = (nib | (p0 << jnp.uint8(4)) | (p1 << jnp.uint8(5))
         | (p2 << jnp.uint8(6)))                             # 7-bit codewords
    # pack 8 codewords -> 7 bytes (bit k of the 56-bit group = codeword k//7
    # ... codeword j occupies bits 7j..7j+6, LSB-first)
    n_code = 2 * n
    g = -(-n_code // 8)
    v = jnp.pad(v, [(0, 0)] * (v.ndim - 1) + [(0, 8 * g - n_code)])
    v = v.reshape(*v.shape[:-1], g, 8)
    vj = [v[..., j] for j in range(8)]
    out = jnp.stack([
        vj[0] | (vj[1] << jnp.uint8(7)),
        (vj[1] >> jnp.uint8(1)) | (vj[2] << jnp.uint8(6)),
        (vj[2] >> jnp.uint8(2)) | (vj[3] << jnp.uint8(5)),
        (vj[3] >> jnp.uint8(3)) | (vj[4] << jnp.uint8(4)),
        (vj[4] >> jnp.uint8(4)) | (vj[5] << jnp.uint8(3)),
        (vj[5] >> jnp.uint8(5)) | (vj[6] << jnp.uint8(2)),
        (vj[6] >> jnp.uint8(6)) | (vj[7] << jnp.uint8(1)),
    ], axis=-1).reshape(*v.shape[:-2], 7 * g)
    return out[..., :encoded_len(n)]


def decode(coded: jnp.ndarray, n_bytes: int) -> jnp.ndarray:
    """uint8[..., m] coded stream -> uint8[..., n_bytes] corrected data.

    ``n_bytes``: original data length (the modem header supplies it).
    """
    coded = coded.astype(jnp.uint8)
    n_code = 2 * n_bytes
    g = -(-n_code // 8)
    pad = 7 * g - coded.shape[-1]
    if pad > 0:
        coded = jnp.pad(coded, [(0, 0)] * (coded.ndim - 1) + [(0, pad)])
    b = coded[..., :7 * g].reshape(*coded.shape[:-1], g, 7)
    bj = [b[..., j] for j in range(7)]
    m = jnp.uint8(127)
    v = jnp.stack([
        bj[0] & m,
        ((bj[0] >> jnp.uint8(7)) | (bj[1] << jnp.uint8(1))) & m,
        ((bj[1] >> jnp.uint8(6)) | (bj[2] << jnp.uint8(2))) & m,
        ((bj[2] >> jnp.uint8(5)) | (bj[3] << jnp.uint8(3))) & m,
        ((bj[3] >> jnp.uint8(4)) | (bj[4] << jnp.uint8(4))) & m,
        ((bj[4] >> jnp.uint8(3)) | (bj[5] << jnp.uint8(5))) & m,
        ((bj[5] >> jnp.uint8(2)) | (bj[6] << jnp.uint8(6))) & m,
        (bj[6] >> jnp.uint8(1)) & m,
    ], axis=-1)                                        # [..., g, 8] codewords
    d0, d1 = _one(v), _one(v >> jnp.uint8(1))
    d2, d3 = _one(v >> jnp.uint8(2)), _one(v >> jnp.uint8(3))
    c4, c5 = _one(v >> jnp.uint8(4)), _one(v >> jnp.uint8(5))
    c6 = _one(v >> jnp.uint8(6))
    # syndrome s = H @ c over GF(2); flip data bit j iff s == H[:, j]
    s0, s1, s2 = d0 ^ d1 ^ d3 ^ c4, d0 ^ d2 ^ d3 ^ c5, d1 ^ d2 ^ d3 ^ c6
    ns0, ns1, ns2 = s0 ^ jnp.uint8(1), s1 ^ jnp.uint8(1), s2 ^ jnp.uint8(1)
    nib = ((d0 ^ (s0 & s1 & ns2))
           | ((d1 ^ (s0 & ns1 & s2)) << jnp.uint8(1))
           | ((d2 ^ (ns0 & s1 & s2)) << jnp.uint8(2))
           | ((d3 ^ (s0 & s1 & s2)) << jnp.uint8(3)))  # [..., g, 8]
    lo, hi = nib[..., 0::2], nib[..., 1::2]
    out = (lo | (hi << jnp.uint8(4))).reshape(*nib.shape[:-2], 4 * g)
    return out[..., :n_bytes]
