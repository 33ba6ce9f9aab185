"""Independent sequential oracle receiver (test-only).

A deliberately naive, loop-based float64 numpy implementation of the
reference receiver's math (src/receiver.rs:8-96), written directly from the
cited formulas.  The production decoder is a batched tensor program; decoding
the same stream through both and comparing post-FEC bytes bit-for-bit guards
the batched implementation against structural mistakes a shared-code test
could never catch.

QAM-16/64/256 decisions follow ofdm_tpu/phy/modulation.py's Gray mapping
(the reference's QAM arms are stubs): each axis picks the nearest odd
integer level, its rank is Gray-coded, and the I bits precede the Q bits,
LSB-first.
"""

from __future__ import annotations

import numpy as np

from ofdm_tpu import constants
from ofdm_tpu.config import DEFAULT_CONFIG


_QAM_HALF_BITS = {"qam16": 2, "qam64": 3, "qam256": 4}


def oracle_decode(samples: np.ndarray, guard_bands: bool, modulation: str,
                  cfg=DEFAULT_CONFIG) -> np.ndarray:
    """Sequential reference-math decode -> raw bytes (header included)."""
    samples = np.asarray(samples, dtype=np.complex128)
    lock = constants.locking_for(cfg)
    k = cfg.sym_len

    # frame sync: c[lag] = sum_n s[lag+n] * conj(lock[n]); offset = argmax-1
    t = samples.size
    power = np.empty(t, dtype=np.float64)
    c = np.empty(t, dtype=np.complex128)
    padded = np.concatenate([samples, np.zeros(k, np.complex128)])
    for lag in range(t):
        c[lag] = np.dot(padded[lag:lag + k], np.conj(lock))
        power[lag] = abs(c[lag]) ** 2
    offset = int(np.argmax(power)) - 1
    offset = max(offset, 0)
    s = samples[offset:]

    # chunking with zero-padded tail
    n_chunks = -(-len(s) // k)
    s = np.concatenate([s, np.zeros(n_chunks * k - len(s), np.complex128)])
    chunks = s.reshape(n_chunks, k)

    # CFO from the last two preamble chunks
    last = cfg.n_locking + cfg.n_preamble - 1
    angles = np.angle(chunks[last] / chunks[last - 1])
    f_delta = abs(np.mean(angles) / k)

    # global derotation, sequential sample counter
    sample_id = 0
    for ci in range(n_chunks):
        for j in range(k):
            chunks[ci, j] *= np.exp(-1j * f_delta * sample_id)
            sample_id += 1

    # channel estimate from training chunks
    training = constants.training_signals(cfg.n_fft, cfg.training_seed)
    t0 = cfg.n_locking + cfg.n_preamble
    h_k = np.zeros(cfg.n_fft, np.complex128)
    for ci in range(t0, t0 + cfg.n_training):
        h_k += np.fft.fft(chunks[ci, cfg.cp_len:]) / training
    h_k /= cfg.n_training

    # per data chunk: CP strip, FFT, equalize, pilot phase, extract
    out_syms = []
    for ci in range(cfg.n_sync_chunks, n_chunks):
        y = np.fft.fft(chunks[ci, cfg.cp_len:]) / h_k
        if guard_bands:
            phi = float(np.mean([np.angle(y[p]) for p in cfg.pilot_indices]))
            block = [y[i] * np.exp(-1j * phi) for i in cfg.data_indices]
        else:
            block = list(y)
        out_syms.extend(block)

    # demodulate
    bits = []
    for sym in out_syms:
        re, im = sym.real, sym.imag
        if modulation == "bpsk":
            bits.append(re > 0.0)
        elif modulation == "qpsk":
            l = re >= 0.0
            r = (im >= 0.0) if l else (im > 0.0)
            bits.extend([l, r])
        elif modulation in _QAM_HALF_BITS:
            half = _QAM_HALF_BITS[modulation]
            n_levels = 1 << half
            for v in (re, im):
                rank = min(max(round((v + n_levels - 1) / 2.0), 0),
                           n_levels - 1)
                code = rank ^ (rank >> 1)
                bits.extend(bool((code >> b) & 1) for b in range(half))
        else:
            raise ValueError(modulation)
    n_bytes = len(bits) // 8
    out = np.zeros(n_bytes, np.uint8)
    for i in range(n_bytes):
        for b in range(8):
            out[i] |= int(bits[i * 8 + b]) << b
    return out
