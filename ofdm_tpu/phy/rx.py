"""Receive chain: sample stream -> bytes.

Rebuilds the reference decoder (src/receiver.rs:8-96) as a batched, jittable
pipeline.  The reference's sequential per-sample/per-block loops become fused
tensor ops:

  1. frame sync  — short-kernel sliding correlation against the locking
     signal; offset arithmetic identical to src/receiver.rs:20-25.
  2. CFO         — f_delta = |mean(angle(chunk4/chunk3))/80| (Schmidl-Cox
     style, src/receiver.rs:231-240) applied as exp(-j f_delta n) with a
     global sample index across all chunks (src/receiver.rs:44-50).
  3. channel est — h_k = mean over 5 training blocks of FFT(block[16:])/T_k
     (src/receiver.rs:212-229); equalization Y/h_k (src/receiver.rs:67-70).
  4. phase corr  — per data block, phi = mean over pilots of angle(Y_eq[pilot]);
     that block's data bins *= exp(-j phi) (src/receiver.rs:106-145).  The
     reference applies this retroactively after pushing samples; operating
     block-wise on tensors is equivalent.
  5. demod       — hard decision + LSB-first bit packing (src/receiver.rs:147-190).

Two entry points: ``decode`` (reference-parity, host-driven dynamic length)
and ``decode_frame`` (fully static shapes, batched, one XLA computation —
the production/benchmark path).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from .. import constants
from ..config import DEFAULT_CONFIG, FrameConfig
from ..core.transfer import to_device, to_host
from ..ops.fft import fft
from ..ops.xcorr import locking_sync_offset
from ..packets.header import HEADER_LEN, Header
from .modulation import Modulation


class DecodeError(ValueError):
    """Raised when the stream cannot be decoded (reference: anyhow errors)."""


def sync_offset(samples: jnp.ndarray, cfg: FrameConfig = DEFAULT_CONFIG,
                compute_dtype=None) -> jnp.ndarray:
    """Reference frame-sync offset (batched over leading axes)."""
    dtype = np.complex64 if samples.dtype == jnp.complex64 else np.complex128
    template = constants.locking_for(cfg).astype(dtype)
    return locking_sync_offset(samples, template, compute_dtype=compute_dtype)


def _cfo_estimate(chunks: jnp.ndarray, cfg: FrameConfig,
                  estimator: str = "reference") -> jnp.ndarray:
    """f_delta from the last two preamble chunks (src/receiver.rs:231-240 uses
    chunks 3 and 4 — the 3rd/4th preamble repeats in the default geometry).

    estimator="reference": mean of per-sample angles, |.|/sym_len — exact
    parity, including its failure when noise wraps individual angles past
    +-pi (drift near pi, i.e. CFO draws with u -> 1; the reference comments
    on this in src/channel.rs:50-54).
    estimator="coherent": angle of the complex-averaged lag product
    angle(sum right*conj(left))/sym_len — same statistic on clean signals
    but immune to per-sample wrap outliers, extending usable CFO right up to
    the pi/sym_len ambiguity bound.
    """
    last = cfg.n_locking + cfg.n_preamble - 1
    return _cfo_estimate_lr(chunks[..., last - 1, :], chunks[..., last, :],
                            cfg, estimator)


def _cfo_estimate_lr(left, right, cfg: FrameConfig, estimator: str):
    """CFO estimate from the two preamble chunks (see _cfo_estimate)."""
    if estimator == "coherent":
        corr = jnp.sum(right * jnp.conj(left), axis=-1)
        return jnp.abs(jnp.angle(corr) / cfg.sym_len)
    ang = jnp.angle(right / left)
    return jnp.abs(jnp.mean(ang, axis=-1) / cfg.sym_len)


def _equalize_and_extract(eq: jnp.ndarray, guard_bands: bool, cfg: FrameConfig):
    """Per-block pilot phase correction + data-bin extraction.

    eq: [..., nb, n_fft] equalized blocks -> [..., nb * carriers] symbols.
    """
    if guard_bands:
        pilots = eq[..., list(cfg.pilot_indices)]
        phi = jnp.mean(jnp.angle(pilots), axis=-1, keepdims=True)
        data = eq[..., cfg.data_indices] * jnp.exp(-1j * phi.astype(eq.real.dtype)
                                                   ).astype(eq.dtype)
    else:
        data = eq
    return data.reshape(*data.shape[:-2], -1)


# Resolution of derot_impl="auto" (decode_frame, streaming).  "stream"
# derotates the whole sample stream elementwise; "matrix" folds the
# within-symbol phasor into a per-row DFT matrix, so the derotated stream is
# never written.  Byte-identical (tests/test_decode_options.py); "matrix"
# moves one full-stream pass less.
_DEROT_AUTO = "matrix"

# decode_frame's align_impl values: "xla" (sync correlation + alignment
# gather as XLA ops) and "triton" (kernels/sync_align.py, the fused GPU
# kernel); "auto" picks "triton" on the GPU where the kernel applies.
ALIGN_IMPLS = ("auto", "xla", "triton")


def _derot_matrix_core(cp_re, cp_im, *, n_chunks: int, guard_bands: bool,
                       modulation: Modulation, cfg: FrameConfig,
                       dft_precision, cfo_estimator: str):
    """Matrix-derot decode tail on PLANAR chunk views f32[..., n_chunks, sym].

    Shared by decode_aligned's derot_impl="matrix" branch (which splits its
    complex chunks into planes — same cost as the packed concat it replaces)
    and decode_planar_matrix (which takes the planes the fused sync+align
    kernel writes, so the aligned stream is never materialized as
    complex64).  Receives RAW (un-derotated) planes; the CFO derotation
    reaches the data blocks only through the per-row DFT matrix + the
    per-chunk phase on the bin tensor, so the sample stream is read exactly
    once (by the two planar DFT matmuls).  Only the n_training + chunk-6
    slices (tiny) are assembled as complex.
    """
    from ..ops.fft import dft_matmul_select_derot_planar
    sym = cfg.sym_len
    rd = cp_re.dtype
    cplx = jax.lax.complex
    last = cfg.n_locking + cfg.n_preamble - 1
    f_delta = _cfo_estimate_lr(
        cplx(cp_re[..., last - 1, :], cp_im[..., last - 1, :]),
        cplx(cp_re[..., last, :], cp_im[..., last, :]), cfg, cfo_estimator)
    chunk6 = cplx(cp_re[..., 6, :], cp_im[..., 6, :])

    def phasor(angles):
        return jnp.exp(jax.lax.complex(jnp.zeros_like(angles), -angles))

    # Channel estimate: derotate just the n_training chunks (tiny tensor).
    t0 = cfg.n_locking + cfg.n_preamble
    tr_raw = cplx(cp_re[..., t0:t0 + cfg.n_training, cfg.cp_len:],
                  cp_im[..., t0:t0 + cfg.n_training, cfg.cp_len:])
    tr_idx = ((jnp.arange(cfg.n_training, dtype=rd) + t0) * sym)[:, None] \
        + (jnp.arange(cfg.n_fft, dtype=rd) + cfg.cp_len)[None, :]
    tr = tr_raw * phasor(f_delta[..., None, None] * tr_idx).astype(tr_raw.dtype)
    training_ref = jnp.asarray(
        constants.training_signals(cfg.n_fft, cfg.training_seed),
        dtype=tr_raw.dtype)
    h_k = jnp.mean(fft(tr) / training_ref, axis=-2)

    chunk6_post = chunk6 * phasor(
        f_delta[..., None] * (jnp.arange(sym, dtype=rd) + 6 * sym)
    ).astype(chunk6.dtype)

    if guard_bands:
        nd = len(cfg.data_indices)
        sel = tuple(cfg.data_indices) + tuple(cfg.pilot_indices)
        default_prec = jax.lax.Precision.HIGH
    else:
        nd = cfg.n_fft
        sel = tuple(range(cfg.n_fft))
        # stream-path parity: the non-guard arm defaults to the
        # full-precision transform (channel est divides by these outputs)
        default_prec = jax.lax.Precision.HIGHEST
    prec = dft_precision if dft_precision is not None else default_prec

    y = dft_matmul_select_derot_planar(
        cp_re[..., cfg.n_sync_chunks:, cfg.cp_len:],
        cp_im[..., cfg.n_sync_chunks:, cfg.cp_len:],
        sel, f_delta, sample_offset=cfg.cp_len, precision=prec)
    # per-chunk derotation phase, applied on the (small) bin tensor where it
    # fuses into the equalize divide
    n_data = n_chunks - cfg.n_sync_chunks
    rot_dc = phasor(f_delta[..., None]
                    * ((jnp.arange(n_data, dtype=rd) + cfg.n_sync_chunks)
                       * sym))
    y = y * rot_dc[..., :, None].astype(y.dtype)

    if guard_bands:
        eq = y / h_k[..., sel][..., None, :]
        phi = jnp.mean(jnp.angle(eq[..., nd:]), axis=-1, keepdims=True)
        data = eq[..., :nd] * jnp.exp(-1j * phi.astype(eq.real.dtype)
                                      ).astype(eq.dtype)
        syms = data.reshape(*data.shape[:-2], -1)
    else:
        eq = y / h_k[..., None, :]
        syms = _equalize_and_extract(eq, guard_bands, cfg)
    from .modulation import demodulate_symbols_packed
    out = demodulate_symbols_packed(syms, modulation)
    diag = {"f_delta": f_delta, "h_k": h_k, "equalized": syms,
            "chunk6_pre": chunk6, "chunk6_post": chunk6_post}
    return out, diag


@partial(jax.jit, static_argnames=("n_chunks", "guard_bands", "modulation",
                                   "cfg", "dft_precision", "cfo_estimator"))
def decode_planar_matrix(planes: jnp.ndarray, *, n_chunks: int,
                         guard_bands: bool = False,
                         modulation: Modulation = Modulation.BPSK,
                         cfg: FrameConfig = DEFAULT_CONFIG,
                         dft_precision=None,
                         cfo_estimator: str = "reference"):
    """Matrix-derot decode of a PLANAR aligned stream.

    ``planes``: f32[..., 2, n_chunks * sym_len] real/imag planes of the
    sync-aligned stream — exactly what ``kernels.sync_align.sync_align``
    returns — batched over leading axes.  Same outputs as
    ``decode_aligned(complex(planes[...,0,:], planes[...,1,:]),
    derot_impl="matrix")`` (to f32 rounding; byte-identical at operating
    SNRs, gated by tests), but the complex64 aligned stream is never built,
    which saves one full write and re-read of the aligned intermediate.
    """
    sym = cfg.sym_len
    cp = planes[..., : n_chunks * sym].reshape(
        *planes.shape[:-1], n_chunks, sym)
    return _derot_matrix_core(cp[..., 0, :, :], cp[..., 1, :, :],
                              n_chunks=n_chunks, guard_bands=guard_bands,
                              modulation=modulation, cfg=cfg,
                              dft_precision=dft_precision,
                              cfo_estimator=cfo_estimator)


@partial(jax.jit, static_argnames=("n_chunks", "guard_bands", "modulation",
                                   "cfg", "dft_precision", "cfo_estimator",
                                   "derot_impl"))
def decode_aligned(aligned: jnp.ndarray, *, n_chunks: int,
                   guard_bands: bool = False,
                   modulation: Modulation = Modulation.BPSK,
                   cfg: FrameConfig = DEFAULT_CONFIG,
                   dft_precision=None, cfo_estimator: str = "reference",
                   derot_impl: str = "stream"):
    """Decode a sync-aligned stream of exactly ``n_chunks * sym_len`` samples.

    Returns (bytes_u8[..., n_bytes], diagnostics dict).  Batched over leading
    axes.  The stream must start at the locking block (post sync trim).

    ``derot_impl`` selects the CFO-derotation lowering ("stream" / "matrix" /
    "auto"; see _DEROT_AUTO).
    """
    sym = cfg.sym_len
    chunks = aligned[..., : n_chunks * sym].reshape(*aligned.shape[:-1], n_chunks, sym)
    rd = jnp.real(aligned).dtype

    if derot_impl == "auto":
        derot_impl = _DEROT_AUTO
    if derot_impl == "matrix":
        # Fold the within-symbol derotation phasor into a per-row DFT matrix
        # (ops/fft.py) instead of materializing a derotated copy of the
        # whole stream: the full-stream elementwise complex-multiply pass is
        # the largest memory tranche of the stream derotation.  Only the 5
        # training chunks and the chunk-6 debug tap are derotated
        # elementwise (tiny), and the remaining per-chunk phase fuses into
        # the equalizer on the (small) bin tensor.  Mathematically identical
        # to the stream path; agrees to f32 rounding, byte-identical at any
        # workable SNR (tests/test_decode_options.py).
        return _derot_matrix_core(
            jnp.real(chunks), jnp.imag(chunks), n_chunks=n_chunks,
            guard_bands=guard_bands, modulation=modulation, cfg=cfg,
            dft_precision=dft_precision, cfo_estimator=cfo_estimator)

    # CFO estimate + global derotation (sample index spans all chunks).
    # exp(-i f (sym*c + j)) factors into an outer product of two short
    # phasor vectors, so only n_chunks + sym transcendentals are evaluated
    # instead of one per sample — the rest is cheap complex multiplies.
    f_delta = _cfo_estimate(chunks, cfg, cfo_estimator)
    chunk6_pre = chunks[..., 6, :]      # reference debug tap (receiver.rs:41)
    c_idx = jnp.arange(n_chunks, dtype=rd) * sym
    j_idx = jnp.arange(sym, dtype=rd)

    def phasor(angles):
        return jnp.exp(jax.lax.complex(jnp.zeros_like(angles), -angles))

    rot_c = phasor(f_delta[..., None] * c_idx)        # [..., n_chunks]
    rot_j = phasor(f_delta[..., None] * j_idx)        # [..., sym]
    rot = rot_c[..., :, None] * rot_j[..., None, :]
    chunks = chunks * rot.astype(chunks.dtype)

    # Channel estimate from the 5 training chunks.
    t0 = cfg.n_locking + cfg.n_preamble
    training_rx = chunks[..., t0:t0 + cfg.n_training, cfg.cp_len:]
    training_ref = jnp.asarray(
        constants.training_signals(cfg.n_fft, cfg.training_seed), dtype=chunks.dtype)
    h_k = jnp.mean(fft(training_rx) / training_ref, axis=-2)

    # Data blocks: CP strip + DFT + equalize.  dft_precision trades speed
    # for accuracy on the (large) data-block transform; the (small)
    # channel-estimation transform above always stays at full precision.
    # The default is HIGH: QAM256's 55 dB operating point needs far less
    # than f32 accuracy (PERF.md states what each setting lowers to on the
    # GPU and the margin it leaves).  With guard bands on, the DFT is
    # evaluated only at the 52 used bins (48 data + 4 pilots) as a packed
    # [.., 128] x [128, 104] matmul — the guard bins are never computed and
    # equalize/pilot-phase/demod run on the packed layout with no 64-bin
    # intermediate (byte-identical to the full transform).
    from ..ops.fft import dft_matmul, dft_matmul_select
    data_t = chunks[..., cfg.n_sync_chunks:, cfg.cp_len:]
    prec = dft_precision if dft_precision is not None \
        else jax.lax.Precision.HIGH
    if guard_bands:
        nd = len(cfg.data_indices)
        sel = tuple(cfg.data_indices) + tuple(cfg.pilot_indices)
        y = dft_matmul_select(data_t, sel, precision=prec)
        eq = y / h_k[..., sel][..., None, :]
        phi = jnp.mean(jnp.angle(eq[..., nd:]), axis=-1, keepdims=True)
        data = eq[..., :nd] * jnp.exp(-1j * phi.astype(eq.real.dtype)
                                      ).astype(eq.dtype)
        syms = data.reshape(*data.shape[:-2], -1)
    else:
        if dft_precision is not None:
            y = dft_matmul(data_t, precision=dft_precision)
        else:
            y = fft(data_t)
        eq = y / h_k[..., None, :]
        syms = _equalize_and_extract(eq, guard_bands, cfg)
    # SoA demod+pack: per-symbol uint8 codes + shift/or packing — no
    # n_syms*bps bool bit tensor (byte-identical, locked by tests; the same
    # treatment as fec/hamming.py)
    from .modulation import demodulate_symbols_packed
    out = demodulate_symbols_packed(syms, modulation)
    diag = {"f_delta": f_delta, "h_k": h_k, "equalized": syms,
            "chunk6_pre": chunk6_pre, "chunk6_post": chunks[..., 6, :]}
    return out, diag


def _planar_align(flat: jnp.ndarray, offsets: jnp.ndarray,
                  need: int) -> jnp.ndarray:
    """Per-row alignment gather: complex[R, T], int[R] -> complex[R, need].

    One dynamic_slice of a [2, need] tile per row on the real/imag-stacked
    float planes (complex row gathers lower worse than float ones).
    """
    f = jnp.stack([jnp.real(flat), jnp.imag(flat)], axis=1)   # [R, 2, T]

    def take(row, off):
        return jax.lax.dynamic_slice(row, (jnp.zeros((), off.dtype), off),
                                     (2, need))

    a = jax.vmap(take)(f, offsets)
    return jax.lax.complex(a[:, 0], a[:, 1])


@partial(jax.jit, static_argnames=("cfg",))
def _sync_jit(samples, cfg: FrameConfig = DEFAULT_CONFIG):
    return sync_offset(samples, cfg)


@partial(jax.jit, static_argnames=("n_chunks", "guard_bands", "modulation", "cfg"))
def _align_decode(samples, offset, *, n_chunks: int, guard_bands: bool,
                  modulation: Modulation, cfg: FrameConfig):
    need = n_chunks * cfg.sym_len
    padded = jnp.pad(samples, (0, max(0, need)))
    aligned = jax.lax.dynamic_slice_in_dim(padded, offset, need)
    return decode_aligned(aligned, n_chunks=n_chunks, guard_bands=guard_bands,
                          modulation=modulation, cfg=cfg)


def decode(samples, guard_bands: bool = False,
           modulation: Modulation = Modulation.BPSK,
           cfg: FrameConfig = DEFAULT_CONFIG,
           return_diagnostics: bool = False):
    """Reference-parity decode of one 1-D sample stream (src/receiver.rs:8-96).

    Host-driven: pulls the sync offset to the host, pads the tail chunk with
    zeros like split_into_chunks (src/receiver.rs:192-210), parses the header
    and truncates to packet_length.  Raises DecodeError like the reference's
    early bail on short input.
    """
    samples = samples if isinstance(samples, jax.Array) else to_device(samples)
    offset = int(_sync_jit(samples, cfg))
    # The reference computes offset = peak_lag - 1 and would panic on a
    # negative cast (split_off(-1 as usize)); a clean un-delayed stream sits
    # at peak_lag 0.  Clamp small negatives to 0 — same alignment, no crash.
    if offset == -1:
        offset = 0
    if offset < 0 or offset > samples.shape[-1]:
        raise DecodeError(f"sync offset {offset} out of range")
    remaining = samples.shape[-1] - offset
    if remaining < (cfg.n_sync_chunks * cfg.sym_len):
        raise DecodeError("Input not long enough, bailing early")

    n_chunks = -(-remaining // cfg.sym_len)
    out, diag = _align_decode(samples, offset, n_chunks=n_chunks,
                              guard_bands=guard_bands, modulation=modulation,
                              cfg=cfg)
    from ..obs import taps
    if taps.enabled():
        # reference tap names (src/receiver.rs:41,52,58,76)
        taps.tap("preq_correction_3a", to_host(diag["chunk6_pre"]))
        taps.tap("post_correction_3a", to_host(diag["chunk6_post"]))
        taps.tap("hk_estimate_3a", to_host(diag["h_k"]))
        taps.tap("no_phaseoffset", to_host(diag["equalized"]))
    raw = np.asarray(out)
    if raw.shape[-1] < HEADER_LEN:
        raise DecodeError("decoded stream shorter than header")
    header = Header.from_bytes(raw[:HEADER_LEN].tobytes())
    payload = raw[HEADER_LEN:HEADER_LEN + header.packet_length]
    if header.packet_length > raw.shape[-1] - HEADER_LEN:
        # Reference Vec::truncate caps at available length; mirror that.
        payload = raw[HEADER_LEN:]
    if return_diagnostics:
        diag = {k: to_host(v) for k, v in diag.items()}
        diag["offset"] = offset
        return payload, diag
    return payload


def _use_triton_sync(samples, template, sync_dtype, search_window) -> bool:
    """align_impl="auto": the sync kernel where it applies and pays.  Its
    route writes a planar copy of every whole row before the kernel, which
    only a whole-row scan repays: with a one-symbol ``search_window`` (the
    streaming decoders) the XLA route was faster on the H100 (PERF.md)."""
    from ..kernels import sync_align as ksa
    return (jax.default_backend() == "gpu" and search_window is None
            and samples.dtype == jnp.complex64 and sync_dtype is None
            and ksa.supports(template))


@partial(jax.jit, static_argnames=("n_blocks", "guard_bands", "modulation",
                                   "cfg", "sync_dtype", "search_window",
                                   "dft_precision", "cfo_estimator",
                                   "align_impl", "derot_impl"))
def decode_frame(samples: jnp.ndarray, *, n_blocks: int,
                 guard_bands: bool = False,
                 modulation: Modulation = Modulation.BPSK,
                 cfg: FrameConfig = DEFAULT_CONFIG,
                 sync_dtype=None,
                 search_window: int | None = None,
                 dft_precision=None, cfo_estimator: str = "coherent",
                 align_impl: str = "auto",
                 derot_impl: str = "auto") -> jnp.ndarray:
    """Fully-static batched decode: complex[..., T] -> uint8[..., n_bytes].

    ``n_blocks`` is the expected number of data OFDM symbols (known from the
    deployment config).  Sync offset is resolved on-device with
    ``dynamic_slice`` — no host round-trip — so the whole rx chain is one XLA
    computation.  This is the production streaming/benchmark path.

    ``align_impl`` selects the sync/alignment lowering: "xla" runs the
    banded-Toeplitz sync correlation and the alignment gather as XLA ops;
    "triton" runs the fused sync+align GPU kernel (kernels/sync_align.py)
    and hands its planar window to the matrix tail; "auto" (default) takes
    "triton" on the GPU for a whole-row scan of complex64 input with the
    real locking template and full-precision sync, "xla" everywhere else.

    ``sync_dtype=jnp.bfloat16`` runs the sync correlation with bf16 inputs
    (peak detection is bf16-tolerant).  ``search_window`` bounds the
    acquisition scan to the first W samples when the frame start is
    approximately known (streaming reacquisition); None scans the whole
    buffer like the reference (src/receiver.rs:20).

    ``cfo_estimator`` defaults to "coherent" on this production path: the
    reference's per-sample-angle mean loses whole frames when the CFO draw
    nears the per-sample wrap (identical behavior on clean signals).  The
    parity entry point ``decode`` keeps the reference estimator.
    """
    if align_impl not in ALIGN_IMPLS:
        raise ValueError(f"unknown align_impl {align_impl!r}; "
                         f"expected one of {ALIGN_IMPLS}")
    squeeze = samples.ndim == 1
    if squeeze:
        samples = samples[None, :]
    n_chunks = cfg.n_sync_chunks + n_blocks
    need = n_chunks * cfg.sym_len
    pad = max(0, need - samples.shape[-1])
    samples = jnp.pad(samples, [(0, 0)] * (samples.ndim - 1) + [(0, pad)])

    batch_shape = samples.shape[:-1]
    flat = samples.reshape(-1, samples.shape[-1])
    template = constants.locking_for(cfg)
    derot = _DEROT_AUTO if derot_impl == "auto" else derot_impl
    tail = partial(decode_aligned, n_chunks=n_chunks, guard_bands=guard_bands,
                   modulation=modulation, cfg=cfg,
                   dft_precision=dft_precision, cfo_estimator=cfo_estimator,
                   derot_impl=derot)

    impl = align_impl
    if impl == "auto":
        impl = "triton" if _use_triton_sync(samples, template, sync_dtype,
                                            search_window) else "xla"
    if impl == "triton":
        from ..kernels.sync_align import sync_align
        planes = jnp.stack([jnp.real(flat), jnp.imag(flat)], axis=1)
        win = sync_align(planes, template, need, search_window=search_window,
                         sym_len=cfg.sym_len)
        win = win.reshape(*batch_shape, 2, need)
        if derot == "matrix":
            out, _ = decode_planar_matrix(
                win, n_chunks=n_chunks, guard_bands=guard_bands,
                modulation=modulation, cfg=cfg, dft_precision=dft_precision,
                cfo_estimator=cfo_estimator)
        else:
            out, _ = tail(jax.lax.complex(win[..., 0, :], win[..., 1, :]))
        return out[0] if squeeze else out

    scan = samples if search_window is None else \
        samples[..., : search_window + cfg.sym_len]
    offsets = jnp.clip(sync_offset(scan, cfg, compute_dtype=sync_dtype),
                       0, samples.shape[-1] - need)
    aligned = _planar_align(flat, offsets.reshape(-1), need)
    out, _ = tail(aligned.reshape(*batch_shape, need))
    return out[0] if squeeze else out


def decode_frame_planar(planes: jnp.ndarray, *, n_blocks: int,
                        guard_bands: bool = False,
                        modulation: Modulation = Modulation.BPSK,
                        cfg: FrameConfig = DEFAULT_CONFIG,
                        search_window: int | None = None) -> jnp.ndarray:
    """``decode_frame`` for a PLANAR sample stream f32[..., 2, T].

    Captures are interleaved fc32 on the wire and the native loader
    deinterleaves them to planes (native/iq_loader.cpp).  The planes are
    assembled into complex64 in the same jit graph and decoded by
    ``decode_frame``.  Also accepts the pre-tiled [..., 2, tiles, 128] form
    (``planar_input_format``), whose tile split merges as a free reshape.
    """
    if planes.ndim >= 4 and planes.shape[-1] == 128 and planes.shape[-3] == 2:
        planes = planes.reshape(*planes.shape[:-2], -1)
    assert planes.shape[-2] == 2, "planes must be [..., 2, T]"
    cplx = jax.lax.complex(planes[..., 0, :], planes[..., 1, :])
    return decode_frame(cplx, n_blocks=n_blocks, guard_bands=guard_bands,
                        modulation=modulation, cfg=cfg,
                        search_window=search_window)


def planar_input_format(device=None):
    """jit ``in_shardings`` entry pinning a pre-tiled planar batch argument
    f32[R, 2, tiles, 128] to the row-major layout:

        step = jax.jit(fn, in_shardings=(ot.planar_input_format(), ...))

    XLA may otherwise assign a large planar parameter another layout and
    copy it before use.
    """
    from jax.experimental.layout import Format, Layout
    from jax.sharding import SingleDeviceSharding
    if device is None:
        device = jax.devices()[0]
    return Format(Layout(major_to_minor=(0, 1, 2, 3)),
                  SingleDeviceSharding(device))


def planar_stream_format(device=None):
    """``planar_input_format`` for a pre-tiled STREAM argument: a single
    continuous capture as f32[2, tiles, 128] (tiles = ceil(T/128), row-major
    pinned) — the upload shape for ``streaming.decode_regular`` and the
    serving extractors, which merge the tile split as a free reshape."""
    from jax.experimental.layout import Format, Layout
    from jax.sharding import SingleDeviceSharding
    if device is None:
        device = jax.devices()[0]
    return Format(Layout(major_to_minor=(0, 1, 2)),
                  SingleDeviceSharding(device))
