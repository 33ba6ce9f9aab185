"""Reed-Solomon RS(255,223) over GF(256) — behavior parity with the reference.

The reference streams bytes through the ``reed_solomon`` crate
(src/utils.rs:97-180): 223-byte data chunks (zero-padded), 32 parity bytes
each, generator polynomial prod_{i=0}^{31}(x - alpha^i) over GF(2^8) with
primitive polynomial 0x11d — and, notably, always emits one trailing block on
stream end even when the stream length is an exact multiple (the ``None``
match arm encodes the scratch buffer unconditionally).  ``encode_stream`` /
``decode_stream`` replicate that framing exactly, including the trailing
block and decode's zero-padded final chunk.

This is post-demod byte work at ~1/8 the sample rate, so it runs host-side:
a C++ batch codec (native/rs_codec.cpp, loaded via ctypes) when built, with a
vectorized-numpy fallback (syndromes for all blocks at once; Berlekamp-Massey
per failing block only).
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

_LIB = None
_LIB_PATH = os.path.join(os.path.dirname(__file__), "..", "..", "native",
                         "librs_codec.so")
if os.path.exists(_LIB_PATH):
    try:
        _LIB = ctypes.CDLL(_LIB_PATH)
        _LIB.rs_encode_blocks.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int,
            ctypes.POINTER(ctypes.c_uint8)]
        _LIB.rs_decode_blocks.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int,
            ctypes.POINTER(ctypes.c_uint8)]
        _LIB.rs_threads.restype = ctypes.c_int
    except (OSError, AttributeError):
        _LIB = None


def native_threads() -> int | None:
    """Threads the native codec's batch loops may use (1 where it was built
    without OpenMP); None when the numpy fallback is in use."""
    return None if _LIB is None else int(_LIB.rs_threads())


PRIM_POLY = 0x11D
N = 255
ECC = 32
K = N - ECC  # 223

# --- GF(256) tables ---------------------------------------------------------
_EXP = np.zeros(512, dtype=np.int32)
_LOG = np.zeros(256, dtype=np.int32)
_x = 1
for _i in range(255):
    _EXP[_i] = _x
    _LOG[_x] = _i
    _x <<= 1
    if _x & 0x100:
        _x ^= PRIM_POLY
_EXP[255:510] = _EXP[:255]


def _gf_mul(a, b):
    a = np.asarray(a, dtype=np.int32)
    b = np.asarray(b, dtype=np.int32)
    out = _EXP[(_LOG[a] + _LOG[b]) % 255]
    return np.where((a == 0) | (b == 0), 0, out)


def _gf_pow(a: int, p: int) -> int:
    if a == 0:
        return 0
    return int(_EXP[(_LOG[a] * p) % 255])


def _gf_inv(a):
    return _EXP[(255 - _LOG[np.asarray(a, dtype=np.int32)]) % 255]


def _poly_mul(p, q):
    out = np.zeros(len(p) + len(q) - 1, dtype=np.int32)
    for i, c in enumerate(p):
        out[i:i + len(q)] ^= _gf_mul(c, np.asarray(q))
    return out


def _generator_poly(ecc: int = ECC) -> np.ndarray:
    g = np.array([1], dtype=np.int32)
    for i in range(ecc):
        g = _poly_mul(g, [1, _gf_pow(2, i)])
    return g


_GEN = _generator_poly()

# Parity of a block via the systematic encoding matrix: parity = data @ M over
# GF.  Precompute M[k, ecc] = parity bytes of the unit vector e_k, so encoding
# all blocks is table lookups + XOR-reduction (vectorized across blocks).
def _lfsr_parity_single(data: np.ndarray) -> np.ndarray:
    rem = np.zeros(ECC, dtype=np.int32)
    for byte in data:
        factor = byte ^ rem[0]
        rem = np.roll(rem, -1)
        rem[-1] = 0
        if factor:
            rem ^= _gf_mul(factor, _GEN[1:])
    return rem


_ENC_MATRIX = np.zeros((K, ECC), dtype=np.int32)
for _k in range(K):
    _e = np.zeros(K, dtype=np.int32)
    _e[_k] = 1
    _ENC_MATRIX[_k] = _lfsr_parity_single(_e)

# log of encoding matrix for fast vectorized multiply
_ENC_NONZERO = _ENC_MATRIX != 0


def _parity_blocks(data_blocks: np.ndarray) -> np.ndarray:
    """[B, 223] -> [B, 32] parity, vectorized over blocks via GF matmul."""
    B = data_blocks.shape[0]
    out = np.zeros((B, ECC), dtype=np.int32)
    d = data_blocks.astype(np.int32)
    # parity = XOR_k gf_mul(d[:, k], M[k, :])
    for k in range(K):
        col = d[:, k]
        nz = col != 0
        if not nz.any():
            continue
        prod = np.zeros((B, ECC), dtype=np.int32)
        logs = _LOG[col[nz]][:, None] + _LOG[_ENC_MATRIX[k]][None, :]
        vals = _EXP[logs % 255]
        vals[:, ~_ENC_NONZERO[k]] = 0
        prod[nz] = vals
        out ^= prod
    return out


def encode_blocks(data_blocks: np.ndarray) -> np.ndarray:
    """[B, 223] data -> [B, 255] codewords (data || parity)."""
    data_blocks = np.ascontiguousarray(data_blocks, dtype=np.uint8)
    if _LIB is not None:
        out = np.empty((data_blocks.shape[0], N), dtype=np.uint8)
        _LIB.rs_encode_blocks(
            data_blocks.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            data_blocks.shape[0],
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
        return out
    parity = _parity_blocks(data_blocks)
    return np.concatenate([data_blocks, parity.astype(np.uint8)], axis=1)


# --- decode -----------------------------------------------------------------

_SYND_POWERS = np.array([[_gf_pow(_gf_pow(2, i), N - 1 - j) for j in range(N)]
                         for i in range(ECC)], dtype=np.int32)
_SYND_LOGPOW = _LOG[_SYND_POWERS]


def _syndromes(blocks: np.ndarray) -> np.ndarray:
    """[B, 255] -> [B, 32] syndromes S_i = C(alpha^i)."""
    b = blocks.astype(np.int32)
    nz = b != 0
    logs = _LOG[b]                        # [B, 255]
    out = np.zeros((blocks.shape[0], ECC), dtype=np.int32)
    for i in range(ECC):
        terms = _EXP[(logs + _SYND_LOGPOW[i][None, :]) % 255]
        terms = np.where(nz, terms, 0)
        out[:, i] = np.bitwise_xor.reduce(terms, axis=1)
    return out


def _berlekamp_massey(synd: np.ndarray) -> np.ndarray:
    """One block's error-locator polynomial (ascending powers of x^-1 conv)."""
    C = np.array([1], dtype=np.int32)
    B = np.array([1], dtype=np.int32)
    L, m, b = 0, 1, 1
    for n in range(ECC):
        d = int(synd[n])
        for i in range(1, L + 1):
            if i < len(C):
                d ^= int(_gf_mul(C[i], synd[n - i]))
        if d == 0:
            m += 1
        elif 2 * L <= n:
            T = C.copy()
            coef = _gf_mul(d, _gf_inv(b))
            Bp = np.concatenate([np.zeros(m, dtype=np.int32), B])
            size = max(len(C), len(Bp))
            Cn = np.zeros(size, dtype=np.int32)
            Cn[:len(C)] = C
            Cn[:len(Bp)] ^= _gf_mul(coef, Bp)
            C = Cn
            L = n + 1 - L
            B = T
            b = d
            m = 1
        else:
            coef = _gf_mul(d, _gf_inv(b))
            Bp = np.concatenate([np.zeros(m, dtype=np.int32), B])
            size = max(len(C), len(Bp))
            Cn = np.zeros(size, dtype=np.int32)
            Cn[:len(C)] = C
            Cn[:len(Bp)] ^= _gf_mul(coef, Bp)
            C = Cn
            m += 1
    return C


def _correct_block(block: np.ndarray, synd: np.ndarray) -> np.ndarray | None:
    """Correct one 255-byte block in place; None if uncorrectable."""
    locator = _berlekamp_massey(synd)
    n_errs = len(locator) - 1
    if n_errs > ECC // 2:
        return None
    # Chien search: roots alpha^-j ; position mapping matches syndrome basis
    err_pos = []
    for j in range(N):
        # evaluate locator at alpha^{-(N-1-j)}? Standard: positions where
        # locator(alpha^{-i}) == 0 correspond to error at power i.
        xinv = _gf_pow(2, (255 - j) % 255)
        val = 0
        for deg, c in enumerate(locator):
            val ^= int(_gf_mul(c, _gf_pow(xinv, deg)))
        if val == 0:
            err_pos.append(j)
    if len(err_pos) != n_errs:
        return None
    # Forney algorithm
    synd_poly = synd.astype(np.int32)
    # omega(x) = [S(x) * locator(x)] mod x^ECC  (S ascending)
    omega = np.zeros(ECC, dtype=np.int32)
    for i, c in enumerate(locator):
        if c == 0:
            continue
        hi = min(ECC - i, ECC)
        omega[i:i + hi] ^= _gf_mul(c, synd_poly[:hi])
    out = block.astype(np.int32).copy()
    # derivative of locator: odd-degree terms
    for j in err_pos:
        x = _gf_pow(2, j)           # X_l = alpha^j
        xinv = _gf_inv(np.array(x))
        # omega(X^-1)
        num = 0
        for deg in range(ECC):
            if omega[deg]:
                num ^= int(_gf_mul(omega[deg], _gf_pow(int(xinv), deg)))
        den = 0
        for deg in range(1, len(locator), 2):
            if locator[deg]:
                den ^= int(_gf_mul(locator[deg], _gf_pow(int(xinv), deg - 1)))
        if den == 0:
            return None
        # Forney with fcr=0: e_l = X_l^(1-fcr) * Omega(X_l^-1) / Lambda'(X_l^-1)
        mag = int(_gf_mul(x, _gf_mul(num, _gf_inv(np.array(den)))))
        # position j counts from the END (syndrome basis N-1-j)
        out[N - 1 - j] ^= mag
    return out.astype(np.uint8)


def decode_blocks(blocks: np.ndarray):
    """[B, 255] -> ([B, 223] corrected data, ok_mask[B])."""
    blocks = np.ascontiguousarray(blocks, dtype=np.uint8)
    if _LIB is not None:
        buf = blocks.copy()
        ok = np.empty(buf.shape[0], dtype=np.uint8)
        _LIB.rs_decode_blocks(
            buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            buf.shape[0],
            ok.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
        return buf[:, :K], ok.astype(bool)
    synd = _syndromes(blocks)
    ok = ~(synd != 0).any(axis=1)
    out = blocks[:, :K].copy()
    ok_mask = np.ones(blocks.shape[0], dtype=bool)
    for b in np.nonzero(~ok)[0]:
        fixed = _correct_block(blocks[b], synd[b])
        if fixed is None:
            ok_mask[b] = False
        else:
            out[b] = fixed[:K]
    return out, ok_mask


# --- reference stream framing ----------------------------------------------

def encode_stream(data: bytes | np.ndarray) -> np.ndarray:
    """Reference framing (src/utils.rs:97-137): 223-byte chunks, zero-padded,
    plus an unconditional trailing block (all-zero when len % 223 == 0)."""
    arr = np.frombuffer(bytes(data), np.uint8) if isinstance(
        data, (bytes, bytearray)) else np.asarray(data, dtype=np.uint8)
    n_full = len(arr) // K
    n_blocks = n_full + 1          # trailing block always emitted
    padded = np.zeros(n_blocks * K, dtype=np.uint8)
    padded[:len(arr)] = arr
    return encode_blocks(padded.reshape(n_blocks, K)).reshape(-1)


def decode_payload_rows(rows: np.ndarray, n_bytes: int):
    """Batched ``decode_stream`` over frame rows: uint8[R, payload_len] ->
    (uint8[R, n_bytes], ok[R]) with ONE codec call for all rows.

    Row framing is identical to ``decode_stream`` (255-byte chunks, the final
    partial chunk zero-padded, plus the reference's unconditional trailing
    block — src/utils.rs:152-180), but every row's blocks are concatenated
    into a single ``decode_blocks`` call so the GFNI codec's 64-block SoA
    tiles stay filled (native/rs_codec.cpp): the streaming hot path used to
    pay one underfilled FFI call per 33-block frame row."""
    rows = np.ascontiguousarray(rows, dtype=np.uint8)
    r, plen = rows.shape
    n_blk = plen // N + 1          # the None arm always decodes the scratch buf
    padded = np.zeros((r, n_blk * N), dtype=np.uint8)
    padded[:, :plen] = rows
    out, ok = decode_blocks(padded.reshape(r * n_blk, N))
    data = out.reshape(r, n_blk * K)[:, :n_bytes]
    return data, ok.reshape(r, n_blk).all(axis=1)


def decode_stream(coded: bytes | np.ndarray):
    """Reference framing (src/utils.rs:152-180): 255-byte chunks, the final
    partial chunk zero-padded and decoded too.  Returns (data, ok) where
    ok=False mirrors the crate's decode failure (reference returns None)."""
    arr = np.frombuffer(bytes(coded), np.uint8) if isinstance(
        coded, (bytes, bytearray)) else np.asarray(coded, dtype=np.uint8)
    n_full = len(arr) // N
    rem = len(arr) - n_full * N
    n_blocks = n_full + 1          # the None arm always decodes the scratch buf
    padded = np.zeros(n_blocks * N, dtype=np.uint8)
    padded[:len(arr)] = arr
    out, ok = decode_blocks(padded.reshape(n_blocks, N))
    return out.reshape(-1), bool(ok.all())
