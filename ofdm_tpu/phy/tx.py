"""Transmit chain: bytes -> OFDM sample stream.

Rebuilds the reference encoder (src/transmitter.rs:11-58) as one batched,
jittable computation: the per-block while-loop becomes a
[batch, n_blocks, 64] tensor fed through a single batched matmul IFFT, a cyclic
prefix gather, and a peak normalization.  Wire format is identical:

    [locking(80) | preamble x4 (80 each) | training+CP x5 (80 each) |
     data blocks x N (64-pt IFFT + 16 CP)]  all peak-normalized.

The 16-byte little-endian u128 header precedes the payload in the modulated
stream (src/transmitter.rs:36-47).
"""

from __future__ import annotations

from functools import lru_cache, partial

import jax
import jax.numpy as jnp
import numpy as np

from .. import constants
from ..config import DEFAULT_CONFIG, FrameConfig
from ..ops.fft import ifft
from ..packets.header import Header
from .modulation import BITS_PER_SYMBOL, Modulation


@lru_cache(maxsize=None)
def _sync_prefix(cfg: FrameConfig) -> np.ndarray:
    """The constant frame prefix: locking + preambles + prefixed training."""
    lock = constants.locking_for(cfg)
    pre = constants.preamble(cfg.sym_len, cfg.preamble_seed)
    train = constants.training_signals(cfg.n_fft, cfg.training_seed)
    t_time = np.fft.ifft(train)
    t_prefixed = np.concatenate([t_time[-cfg.cp_len:], t_time])
    parts = ([lock] * cfg.n_locking + [pre] * cfg.n_preamble
             + [t_prefixed] * cfg.n_training)
    return np.concatenate(parts)


def n_data_blocks(payload_len: int, modulation: Modulation, guard_bands: bool,
                  cfg: FrameConfig = DEFAULT_CONFIG) -> int:
    """Number of data OFDM symbols for a payload of ``payload_len`` bytes
    (header included automatically, zero-padded final block)."""
    n_bits = (payload_len + cfg.header_len_bytes) * 8
    bps = BITS_PER_SYMBOL[modulation]
    n_syms = -(-n_bits // bps)
    carriers = cfg.carriers_per_block(guard_bands)
    return -(-n_syms // carriers)


def frame_len(payload_len: int, modulation: Modulation, guard_bands: bool,
              cfg: FrameConfig = DEFAULT_CONFIG) -> int:
    """Total samples in the transmitted frame."""
    nb = n_data_blocks(payload_len, modulation, guard_bands, cfg)
    return cfg.sync_len + nb * cfg.sym_len


def symbols_to_blocks(syms: jnp.ndarray, guard_bands: bool,
                      cfg: FrameConfig = DEFAULT_CONFIG) -> jnp.ndarray:
    """complex[..., n_syms] -> complex[..., n_blocks, n_fft] frequency-domain
    blocks with guard/pilot layout (src/transmitter.rs:144-165).  Pads the
    final block with zeros like the reference's ``unwrap_or(0)``."""
    grouped = _group_symbols(syms, cfg.carriers_per_block(guard_bands))
    if not guard_bands:
        return grouped
    blocks = jnp.zeros((*grouped.shape[:-1], cfg.n_fft), dtype=syms.dtype)
    blocks = blocks.at[..., cfg.data_indices].set(grouped)
    blocks = blocks.at[..., list(cfg.pilot_indices)].set(
        jnp.asarray(cfg.pilot_value, dtype=syms.dtype))
    return blocks


def blocks_to_samples(blocks: jnp.ndarray, cfg: FrameConfig = DEFAULT_CONFIG) -> jnp.ndarray:
    """IFFT + cyclic prefix + flatten: [..., nb, n_fft] -> [..., nb*sym_len]."""
    t = ifft(blocks)
    prefixed = jnp.concatenate([t[..., -cfg.cp_len:], t], axis=-1)
    return prefixed.reshape(*prefixed.shape[:-2], -1)


def peak_normalize(stream: jnp.ndarray) -> jnp.ndarray:
    """Divide by the max positive real/imag component (src/transmitter.rs:183-194
    takes max(re, im) without abs; replicated exactly), per frame row."""
    m = jnp.maximum(jnp.max(jnp.real(stream), axis=-1),
                    jnp.max(jnp.imag(stream), axis=-1))
    return stream / m[..., None]


@lru_cache(maxsize=None)
def _pilot_time(cfg: FrameConfig) -> np.ndarray:
    """Time-domain waveform of the constant pilot tones (one per block)."""
    spec = np.zeros(cfg.n_fft, dtype=np.complex128)
    spec[list(cfg.pilot_indices)] = cfg.pilot_value
    return np.fft.ifft(spec)


@lru_cache(maxsize=None)
def _pilot_time_cp(cfg: FrameConfig) -> np.ndarray:
    """Pilot waveform with its cyclic prefix prepended (sym_len samples)."""
    p = _pilot_time(cfg)
    return np.concatenate([p[-cfg.cp_len:], p])


def _group_symbols(syms: jnp.ndarray, carriers: int) -> jnp.ndarray:
    """complex[..., n_syms] -> complex[..., nb, carriers], zero-padded tail
    (the reference's ``unwrap_or(0)``, src/transmitter.rs:149)."""
    nb = -(-syms.shape[-1] // carriers)
    pad = nb * carriers - syms.shape[-1]
    syms = jnp.pad(syms, [(0, 0)] * (syms.ndim - 1) + [(0, pad)])
    return syms.reshape(*syms.shape[:-1], nb, carriers)


@partial(jax.jit, static_argnames=("guard_bands", "modulation", "cfg", "dtype",
                                   "pack_spectrum"))
def encode_payload(payload: jnp.ndarray, *, guard_bands: bool = False,
                   modulation: Modulation = Modulation.BPSK,
                   cfg: FrameConfig = DEFAULT_CONFIG,
                   dtype=jnp.complex64,
                   pack_spectrum: bool | None = None) -> jnp.ndarray:
    """Jitted batched encoder: uint8[..., L] (header already prepended)
    -> complex[..., frame_len].

    ``pack_spectrum`` (guard-bands only): evaluate the per-symbol IFFT from
    the 48 populated data bins directly (packed [.., 96] x [96, 128] matmul +
    the constant pilot waveform) instead of scattering into 64 bins and
    transforming all of them — the tx-side dual of the receiver's 52-bin
    packed DFT.  Numerically equivalent (different float summation order, so
    last-ulp differences); ``None`` enables it for the complex64 production
    path and keeps the scatter + full-IFFT path for complex128 so the golden
    wire-format fixtures stay bit-exact.
    """
    if pack_spectrum is None:
        pack_spectrum = guard_bands and jnp.dtype(dtype) == jnp.complex64
    # SoA byte->symbol mapping: no bit-tensor expansion (value-identical to
    # modulate_bits(bytes_to_bits(payload)); locked by tests + golden frames)
    from .modulation import modulate_bytes_packed
    syms = modulate_bytes_packed(payload, modulation, dtype=dtype)
    if pack_spectrum and guard_bands:
        # CP folded into the IFFT matrix (bitwise-identical columns): the
        # matmul writes prefixed 80-sample blocks directly — no [..., cp]
        # gather + concat pass over the full stream (ops/fft.py
        # idft_matmul_rows_cp)
        from ..ops.fft import idft_matmul_rows_cp
        grouped = _group_symbols(syms, cfg.carriers_per_block(True))
        t = idft_matmul_rows_cp(grouped, tuple(cfg.data_indices), cfg.n_fft,
                                cfg.cp_len)
        t = t + jnp.asarray(_pilot_time_cp(cfg), dtype=dtype)
        data_samples = t.reshape(*t.shape[:-2], -1)
    else:
        blocks = symbols_to_blocks(syms, guard_bands, cfg)
        data_samples = blocks_to_samples(blocks, cfg)
    # Peak-normalize without materializing the unscaled frame: the sync
    # prefix is a compile-time constant, so its peak is too — the max
    # reduction runs over the data samples only and the divide fuses into
    # the prefix/data concat write (one less full-stream pass; max() is
    # exact so the scale factor, and hence every output element, is
    # BITWISE identical to peak_normalize(concat(...))).
    prefix_np = _sync_prefix(cfg).astype(jnp.dtype(dtype).name)
    pm = max(float(prefix_np.real.max()), float(prefix_np.imag.max()))
    m = jnp.maximum(jnp.max(jnp.real(data_samples), axis=-1),
                    jnp.max(jnp.imag(data_samples), axis=-1))
    m = jnp.maximum(m, jnp.asarray(pm, dtype=m.dtype))[..., None]
    prefix = jnp.broadcast_to(jnp.asarray(prefix_np),
                              (*data_samples.shape[:-1], prefix_np.shape[0]))
    return jnp.concatenate([prefix / m, data_samples / m], axis=-1)


@partial(jax.jit, static_argnames=("guard_bands", "modulation", "cfg", "dtype"))
def encode_hamming(data: jnp.ndarray, *, guard_bands: bool = False,
                   modulation: Modulation = Modulation.BPSK,
                   cfg: FrameConfig = DEFAULT_CONFIG,
                   dtype=jnp.complex64) -> jnp.ndarray:
    """Fused FEC + modem encoder: uint8[..., n] USER bytes -> frames whose
    payload is the Hamming(7,4)-coded stream (the tx dual of the fused rx
    Hamming tail in phy/streaming.py).  One dispatch: SoA FEC bit math +
    header + SoA byte->symbol mapping + packed IFFT.  Wire-identical to
    ``encode(hamming.encode(data), ...)``.
    """
    from ..fec import hamming
    from ..packets.header import Header
    coded = hamming.encode(data)
    # header depends only on the (static) coded length -> a trace constant
    hdr = np.frombuffer(Header(coded.shape[-1]).to_bytes(), dtype=np.uint8)
    hdr = jnp.broadcast_to(jnp.asarray(hdr), (*coded.shape[:-1], hdr.shape[0]))
    payload = jnp.concatenate([hdr, coded], axis=-1)
    return encode_payload(payload, guard_bands=guard_bands,
                          modulation=modulation, cfg=cfg, dtype=dtype)


def encode(data, guard_bands: bool = False,
           modulation: Modulation = Modulation.BPSK,
           cfg: FrameConfig = DEFAULT_CONFIG, dtype=jnp.complex64) -> jnp.ndarray:
    """Reference-parity entry point (src/transmitter.rs:11-58).

    ``data``: bytes | uint8[L] | uint8[B, L].  Returns complex[(B,) T].
    """
    arr = np.frombuffer(bytes(data), dtype=np.uint8) if isinstance(
        data, (bytes, bytearray)) else np.asarray(data, dtype=np.uint8)
    header = np.frombuffer(Header(arr.shape[-1]).to_bytes(), dtype=np.uint8)
    header = np.broadcast_to(header, (*arr.shape[:-1], header.shape[0]))
    payload = np.concatenate([header, arr], axis=-1)
    return encode_payload(jnp.asarray(payload), guard_bands=guard_bands,
                          modulation=modulation, cfg=cfg, dtype=dtype)
