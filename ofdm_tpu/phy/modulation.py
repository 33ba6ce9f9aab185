"""Symbol mapping and hard-decision demapping.

BPSK/QPSK replicate the reference bit conventions exactly
(src/transmitter.rs:108-140, src/receiver.rs:147-190): bits are consumed
LSB-first per byte; QPSK maps the pair (l, r) to (sign, sign) with
(1,1) -> 1+1j, l driving the real axis.

QAM-16 and QAM-64 are new (the reference's Qam arms are empty stubs —
src/transmitter.rs:135-136, src/receiver.rs:185).  We use Gray-coded square
constellations on odd-integer levels (±1, ±3 / ±1..±7): the first half of each
symbol's bits drives the I axis, the second half the Q axis, each axis
Gray-coded LSB-first.  Integer levels keep hard-decision thresholds exact
(even integers) after equalization.

Everything is shape-polymorphic jnp and vectorizes over leading axes, so
map/demap fuse into the surrounding OFDM computation under jit.
"""

from __future__ import annotations

import enum
from functools import lru_cache

import jax.numpy as jnp
import numpy as np


class Modulation(enum.Enum):
    BPSK = "bpsk"
    QPSK = "qpsk"
    QAM16 = "qam16"
    QAM64 = "qam64"
    QAM256 = "qam256"


BITS_PER_SYMBOL = {
    Modulation.BPSK: 1,
    Modulation.QPSK: 2,
    Modulation.QAM16: 4,
    Modulation.QAM64: 6,
    Modulation.QAM256: 8,
}


@lru_cache(maxsize=None)
def _gray_levels(n_bits: int) -> np.ndarray:
    """Map a Gray-coded n_bits integer (bits LSB-first b0 + 2*b1 + ...) to an
    odd-integer amplitude level.  Index = gray code, value = level."""
    n = 1 << n_bits
    levels = np.zeros(n, dtype=np.float64)
    for rank in range(n):               # rank: position along the axis
        gray = rank ^ (rank >> 1)
        levels[gray] = 2 * rank - (n - 1)
    return levels


@lru_cache(maxsize=None)
def _gray_from_rank(n_bits: int) -> np.ndarray:
    """Index = level rank (0..2^n-1 left to right), value = Gray code."""
    n = 1 << n_bits
    return np.array([r ^ (r >> 1) for r in range(n)], dtype=np.int32)


def _bits_to_int(bits: jnp.ndarray) -> jnp.ndarray:
    """bool[..., k] -> int, LSB-first."""
    k = bits.shape[-1]
    weights = jnp.asarray([1 << i for i in range(k)], dtype=jnp.int32)
    return (bits.astype(jnp.int32) * weights).sum(axis=-1)


def _int_to_bits(vals: jnp.ndarray, k: int) -> jnp.ndarray:
    shifts = jnp.arange(k, dtype=jnp.int32)
    return ((vals[..., None] >> shifts) & 1).astype(jnp.bool_)


def modulate_bits(bits: jnp.ndarray, scheme: Modulation,
                  dtype=jnp.complex64) -> jnp.ndarray:
    """bool[..., n_bits] -> complex[..., n_syms].  If n_bits is not divisible
    by bits/symbol (QAM64's 6 against byte streams), the tail is zero-padded
    into a final partial symbol — bits are never dropped."""
    bps = BITS_PER_SYMBOL[scheme]
    n_sym = -(-bits.shape[-1] // bps)
    pad = n_sym * bps - bits.shape[-1]
    if pad:
        bits = jnp.pad(bits, [(0, 0)] * (bits.ndim - 1) + [(0, pad)])
    bits = bits.reshape(*bits.shape[:-1], n_sym, bps)
    rd = jnp.float32 if dtype == jnp.complex64 else jnp.float64

    if scheme is Modulation.BPSK:
        re = jnp.where(bits[..., 0], 1.0, -1.0).astype(rd)
        return re.astype(dtype)
    if scheme is Modulation.QPSK:
        re = jnp.where(bits[..., 0], 1.0, -1.0).astype(rd)
        im = jnp.where(bits[..., 1], 1.0, -1.0).astype(rd)
        return re.astype(dtype) + 1j * im.astype(dtype)
    # Square QAM: first half of bits -> I Gray code, second half -> Q.
    half = bps // 2
    levels = jnp.asarray(_gray_levels(half), dtype=rd)
    i_code = _bits_to_int(bits[..., :half])
    q_code = _bits_to_int(bits[..., half:])
    re = levels[i_code]
    im = levels[q_code]
    return re.astype(dtype) + 1j * im.astype(dtype)


def modulate_bytes_packed(data: jnp.ndarray, scheme: Modulation,
                          dtype=jnp.complex64) -> jnp.ndarray:
    """uint8[..., n] payload bytes -> complex[..., ceil(n*8/bps)] symbols.

    Identical values to ``modulate_bits(bytes_to_bits(data), scheme)`` (same
    level tables, same zero-padded partial tail symbol; locked by tests) but
    batched: per-symbol bps-bit codes are extracted from byte groups with
    elementwise shift/or math — no n*8 bool bit tensor, no bps-minor reshape
    (the tx dual of demodulate_symbols_packed).
    """
    data = data.astype(jnp.uint8)
    bps = BITS_PER_SYMBOL[scheme]
    n = data.shape[-1]
    n_sym = -(-n * 8 // bps)
    u8 = jnp.uint8
    if scheme is Modulation.QAM256:
        c = data
    else:
        gb = {1: 1, 2: 1, 4: 1, 6: 3}[bps]    # bytes per extract group
        gs = gb * 8 // bps                    # symbols per extract group
        n_grp = -(-n // gb)
        b = jnp.pad(data, [(0, 0)] * (data.ndim - 1) + [(0, n_grp * gb - n)])
        b = b.reshape(*b.shape[:-1], n_grp, gb)
        if bps == 1:
            cs = [(b[..., 0] >> u8(j)) & u8(1) for j in range(8)]
        elif bps == 2:
            cs = [(b[..., 0] >> u8(2 * j)) & u8(3) for j in range(4)]
        elif bps == 4:
            cs = [b[..., 0] & u8(15), b[..., 0] >> u8(4)]
        else:                                  # 6: 3 bytes -> 4 symbols
            b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
            cs = [b0 & u8(63),
                  (b0 >> u8(6)) | ((b1 & u8(15)) << u8(2)),
                  (b1 >> u8(4)) | ((b2 & u8(3)) << u8(4)),
                  b2 >> u8(2)]
        c = jnp.stack(cs, axis=-1).reshape(*b.shape[:-2], n_grp * gs)
    c = c[..., :n_sym]
    rd = jnp.float32 if dtype == jnp.complex64 else jnp.float64
    if scheme is Modulation.BPSK:
        return jnp.where(c != 0, rd(1.0), rd(-1.0)).astype(dtype)
    if scheme is Modulation.QPSK:
        re = jnp.where(c & u8(1), rd(1.0), rd(-1.0))
        im = jnp.where(c & u8(2), rd(1.0), rd(-1.0))
        return re.astype(dtype) + 1j * im.astype(dtype)
    half = bps // 2
    levels = jnp.asarray(_gray_levels(half), dtype=rd)
    re = levels[(c & u8((1 << half) - 1)).astype(jnp.int32)]
    im = levels[(c >> u8(half)).astype(jnp.int32)]
    return re.astype(dtype) + 1j * im.astype(dtype)


def _symbol_codes(re: jnp.ndarray, im: jnp.ndarray,
                  scheme: Modulation) -> jnp.ndarray:
    """Hard-decision per-symbol bit codes: uint8[..., n_syms], bits LSB-first
    (bit 0 = first bit of the symbol on the wire).  Same decision logic as
    demodulate_symbols, without expanding to a bit tensor."""
    if scheme is Modulation.BPSK:
        return (re > 0.0).astype(jnp.uint8)
    if scheme is Modulation.QPSK:
        l = re >= 0.0
        r = jnp.where(l, im >= 0.0, im > 0.0)
        return l.astype(jnp.uint8) | (r.astype(jnp.uint8) << jnp.uint8(1))
    bps = BITS_PER_SYMBOL[scheme]
    half = bps // 2
    n_levels = 1 << half
    gray = jnp.asarray(_gray_from_rank(half).astype(np.uint8))

    def axis_code(v):
        rank = jnp.clip(jnp.round((v + (n_levels - 1)) / 2.0),
                        0, n_levels - 1).astype(jnp.int32)
        return gray[rank]

    return axis_code(re) | (axis_code(im) << jnp.uint8(half))


def demodulate_symbols_packed(syms: jnp.ndarray,
                              scheme: Modulation) -> jnp.ndarray:
    """complex[..., n_syms] -> uint8[..., n_syms*bps//8] packed bytes.

    Byte-identical to ``bits_to_bytes(demodulate_symbols(syms, scheme))``
    (locked by tests) but batched: per-symbol uint8 codes + elementwise
    shift/or packing on [..., G, g] groups — no n_syms*bps bool bit tensor
    and no 8-minor repack reshape (the same SoA treatment as fec/hamming.py).
    """
    bps = BITS_PER_SYMBOL[scheme]
    c = _symbol_codes(jnp.real(syms), jnp.imag(syms), scheme)
    n_sym = c.shape[-1]
    n_bytes = n_sym * bps // 8
    if scheme is Modulation.QAM256:
        return c[..., :n_bytes]
    g = {1: 8, 2: 4, 4: 2, 6: 4}[bps]          # symbols per pack group
    nb = g * bps // 8                          # bytes per pack group
    n_grp = -(-n_sym // g)
    c = jnp.pad(c, [(0, 0)] * (c.ndim - 1) + [(0, n_grp * g - n_sym)])
    c = c.reshape(*c.shape[:-1], n_grp, g)
    cj = [c[..., j] for j in range(g)]
    u8 = jnp.uint8
    if bps == 1:
        out = cj[0]
        for j in range(1, 8):
            out = out | (cj[j] << u8(j))
        out = out[..., None]
    elif bps == 2:
        out = (cj[0] | (cj[1] << u8(2)) | (cj[2] << u8(4))
               | (cj[3] << u8(6)))[..., None]
    elif bps == 4:
        out = (cj[0] | (cj[1] << u8(4)))[..., None]
    else:                                      # 6: 4 symbols -> 3 bytes
        out = jnp.stack([
            cj[0] | (cj[1] << u8(6)),
            (cj[1] >> u8(2)) | (cj[2] << u8(4)),
            (cj[2] >> u8(4)) | (cj[3] << u8(2)),
        ], axis=-1)
    out = out.reshape(*out.shape[:-2], n_grp * nb)
    return out[..., :n_bytes]


def demodulate_symbols(syms: jnp.ndarray, scheme: Modulation) -> jnp.ndarray:
    """complex[..., n_syms] -> bool[..., n_syms * bits/sym] (hard decision)."""
    re = jnp.real(syms)
    im = jnp.imag(syms)

    if scheme is Modulation.BPSK:
        return (re > 0.0)[..., None].reshape(*syms.shape[:-1], -1)
    if scheme is Modulation.QPSK:
        # Exact reference decision table incl. the (re<0, im==0) fallthrough
        # to (0,0) — src/receiver.rs:165-184.
        l = re >= 0.0
        r = jnp.where(l, im >= 0.0, im > 0.0)
        bits = jnp.stack([l, r], axis=-1)
        return bits.reshape(*syms.shape[:-1], -1)

    bps = BITS_PER_SYMBOL[scheme]
    half = bps // 2
    n_levels = 1 << half
    gray = jnp.asarray(_gray_from_rank(half))

    def axis_bits(v):
        # nearest odd-integer level rank: clamp(round((v + n - 1) / 2))
        rank = jnp.clip(jnp.round((v + (n_levels - 1)) / 2.0),
                        0, n_levels - 1).astype(jnp.int32)
        return _int_to_bits(gray[rank], half)

    bits = jnp.concatenate([axis_bits(re), axis_bits(im)], axis=-1)
    return bits.reshape(*syms.shape[:-1], -1)
