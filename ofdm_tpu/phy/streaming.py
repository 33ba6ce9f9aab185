"""Continuous multi-frame stream demodulation (BASELINE config 4).

The reference's live loop decodes one frame per 2M-sample capture buffer
(examples/jetson_rx.rs:83-113).  This module decodes *all* frames in a
continuous stream:

- ``decode_continuous``: host-driven scan for irregular frame spacing —
  re-sync in a fixed-size acquisition window after each frame (one compiled
  shape, so the loop stays jit-cache-friendly).
- ``decode_regular``: the batched fast path when frames are back-to-back or
  evenly spaced (a transmit loop): one reshape + one batched ``decode_frame``
  call demodulates every frame in parallel.

Both compose with the pluggable FEC layer (Hamming(7,4) on-device or
RS(255,223) host-side).
"""

from __future__ import annotations

from typing import Iterator

import jax
import jax.numpy as jnp
import numpy as np

from ..config import DEFAULT_CONFIG, FrameConfig
from ..fec import hamming
from ..fec import reed_solomon as rs
from ..packets.header import HEADER_LEN
from .modulation import Modulation
from .rx import decode_frame, sync_offset
from .tx import n_data_blocks


def _defec(payload: np.ndarray, fec: str | None, n_bytes: int):
    if fec is None:
        return payload[:n_bytes], True
    if fec == "hamming":
        return np.asarray(hamming.decode(jnp.asarray(payload), n_bytes)), True
    if fec == "rs":
        out, ok = rs.decode_stream(payload)
        return out[:n_bytes], ok
    raise ValueError(f"unknown fec {fec!r}")


def coded_len(n_bytes: int, fec: str | None) -> int:
    """Payload bytes on the wire for ``n_bytes`` of user data under ``fec``."""
    if fec is None:
        return n_bytes
    if fec == "hamming":
        return hamming.encoded_len(n_bytes)
    if fec == "rs":
        return (n_bytes // rs.K + 1) * rs.N
    raise ValueError(f"unknown fec {fec!r}")


# Module-level jitted graphs, cached by their static configuration: a
# streaming server calls decode_regular/decode_continuous once per capture
# buffer, and closures defined inside those functions would retrace (and
# recompile) on EVERY buffer.
# Hoisting them here makes repeated calls at one deployment shape hit the
# jit cache (locked by tests/test_streaming.py::test_no_retrace_across_calls).
from functools import partial as _partial


def _norm_sync_argmax(head, template, spacing: int):
    """Normalized-matched-filter sync over ``head`` (the scan prefix):
    rho[L] ∝ |c[L]|^2 / E_window[L].

    The raw |c|^2 argmax (the reference's statistic, src/receiver.rs:20-25)
    can be beaten by a random data segment: QPSK payload draws exist whose
    body out-correlates the true locking block by ~10% and then every frame
    in the buffer decodes garbage (found by the round-5 multichip dryrun at
    mesh data=2).  Dividing by window energy is Cauchy-Schwarz-bounded —
    rho ~= 1 at the true locking block, strictly below for any
    non-proportional segment — the same statistic decode_burst gates on.
    The E_template factor is constant and dropped (argmax-invariant).
    The argmax is restricted to lags < spacing: with identical repeated
    frames the next frame's locking block correlates *exactly* as high,
    and summation-order rounding could otherwise hand the tie to a later
    peak."""
    from ..ops.xcorr import sliding_correlation_matmul
    k = int(np.shape(template)[-1])
    c = sliding_correlation_matmul(head, template)
    power = jnp.real(c) ** 2 + jnp.imag(c) ** 2
    cs = jnp.cumsum(jnp.real(head) ** 2 + jnp.imag(head) ** 2, axis=-1)
    cs = jnp.pad(cs, [(0, 0)] * (cs.ndim - 1) + [(1, 0)])
    e_w = cs[..., k: k + spacing] - cs[..., :spacing]
    rho = power[..., :spacing] / (e_w + np.asarray(1e-30, e_w.dtype))
    return jnp.argmax(rho, axis=-1) - 1


@_partial(jax.jit, static_argnames=("spacing", "need", "cfg"))
def _first_sync(s, *, spacing: int, need: int, cfg: FrameConfig):
    from .. import constants
    template = constants.locking_for(cfg)
    s = jnp.pad(s, (0, max(0, need - s.shape[-1])))
    return _norm_sync_argmax(s[: spacing + cfg.sym_len], template, spacing)


def _fused_defec(out, payload_len: int, n_bytes: int, fec: str | None):
    """In-graph FEC tail: when the codec is device-friendly (Hamming bit
    matmuls), decode the payload inside the same jit computation so the only
    d2h transfer is the corrected user bytes (no raw-payload round trip)."""
    if fec != "hamming":
        return out
    return hamming.decode(out[..., HEADER_LEN:HEADER_LEN + payload_len],
                          n_bytes)


@_partial(jax.jit, static_argnames=("payload_len", "n_bytes"))
def _defec_hamming_device(out, *, payload_len: int, n_bytes: int):
    """Batched on-device Hamming decode of demodulated frame bytes.  Row-wise
    independent, so a data-axis-sharded input stays sharded (used by
    parallel.pipeline.decode_regular_sharded)."""
    return _fused_defec(out, payload_len, n_bytes, "hamming")


@_partial(jax.jit, static_argnames=("n_frames", "spacing", "need", "nb",
                                    "flen", "guard_bands", "modulation", "cfg",
                                    "payload_len", "n_bytes", "fec",
                                    "align_impl"))
def _extract_and_decode(s, first, *, n_frames: int, spacing: int, need: int,
                        nb: int, flen: int, guard_bands: bool,
                        modulation: Modulation, cfg: FrameConfig,
                        payload_len: int = 0, n_bytes: int = 0,
                        fec: str | None = None, align_impl: str = "auto"):
    # Uniform spacing makes frame extraction ONE contiguous dynamic slice +
    # reshape instead of a per-row gather.
    # pad only when the buffer lacks the slack (a pre-tiled pinned
    # stream already carries >= one spare zero tile: zero-copy)
    s = jnp.pad(s, (0, max(0, need + cfg.sym_len - s.shape[-1])))
    rows = jax.lax.dynamic_slice_in_dim(
        s, first, n_frames * spacing).reshape(n_frames, spacing)[:, :flen]
    out = decode_frame(rows, n_blocks=nb, guard_bands=guard_bands,
                       modulation=modulation, cfg=cfg,
                       search_window=cfg.sym_len, align_impl=align_impl)
    return _fused_defec(out, payload_len, n_bytes, fec)


@_partial(jax.jit, static_argnames=("n_frames", "spacing", "need", "nb",
                                    "flen", "guard_bands", "modulation", "cfg",
                                    "payload_len", "n_bytes", "fec"))
def _extract_and_decode_presync(s, first, *, n_frames: int, spacing: int,
                                need: int, nb: int, flen: int,
                                guard_bands: bool, modulation: Modulation,
                                cfg: FrameConfig, payload_len: int = 0,
                                n_bytes: int = 0, fec: str | None = None):
    # With exact spacing the global sync fully determines every frame start:
    # extract rows and run the aligned decoder directly — no per-row re-sync
    # or alignment gather at all.
    from .rx import decode_aligned
    # pad only when the buffer lacks the slack (a pre-tiled pinned
    # stream already carries >= one spare zero tile: zero-copy)
    s = jnp.pad(s, (0, max(0, need + cfg.sym_len - s.shape[-1])))
    rows = jax.lax.dynamic_slice_in_dim(
        s, first, n_frames * spacing).reshape(n_frames, spacing)[:, :flen]
    out, _ = decode_aligned(rows, n_chunks=cfg.n_sync_chunks + nb,
                            guard_bands=guard_bands, modulation=modulation,
                            cfg=cfg, cfo_estimator="coherent",
                            derot_impl="auto")
    return _fused_defec(out, payload_len, n_bytes, fec)


@_partial(jax.jit, static_argnames=("spacing", "need", "cfg"))
def _first_sync_planar(sp, *, spacing: int, need: int, cfg: FrameConfig):
    """_first_sync for a planar stream f32[2, T]: only the scan prefix is
    assembled as complex (spacing + sym_len samples — tiny)."""
    head = min(sp.shape[-1], spacing + cfg.sym_len)
    s = jax.lax.complex(sp[0, :head], sp[1, :head])
    s = jnp.pad(s, (0, max(0, spacing + cfg.sym_len - head)))
    from .. import constants
    template = constants.locking_for(cfg)
    return _norm_sync_argmax(s, template, spacing)


@_partial(jax.jit, static_argnames=("n_frames", "spacing", "need", "nb",
                                    "flen", "guard_bands", "modulation", "cfg",
                                    "payload_len", "n_bytes", "fec",
                                    "handoff"))
def _extract_and_decode_presync_planar(sp, first, *, n_frames: int,
                                       spacing: int, need: int, nb: int,
                                       flen: int, guard_bands: bool,
                                       modulation: Modulation,
                                       cfg: FrameConfig, payload_len: int = 0,
                                       n_bytes: int = 0,
                                       fec: str | None = None,
                                       handoff: str = "planar"):
    """_extract_and_decode_presync on a PLANAR stream f32[2, T].

    ``handoff`` picks the intermediate between row extraction and the
    matrix-derot tail (both end in the same _derot_matrix_core math):

    - "planar": planar rows feed decode_planar_matrix directly — no complex
      stream or aligned intermediate anywhere in the graph; the row
      extraction pays a [2, R, flen] -> [R, 2, flen] transpose.
    - "complex": rows assemble to complex64 and run decode_aligned's matrix
      tail.  Which handoff is fastest on the GPU is not measured yet.
    - "split": the sliced planes feed _derot_matrix_core DIRECTLY as
      separate re/im chunk views — no [2,R,T]->[R,2,T] transpose and no
      complex interleave copy ever exists; structurally the leanest
      composition.
    """
    sp = jnp.pad(sp, ((0, 0),
                      (0, max(0, need + cfg.sym_len - sp.shape[-1]))))
    rows = jax.lax.dynamic_slice_in_dim(
        sp, first, n_frames * spacing, axis=1)
    rows = rows.reshape(2, n_frames, spacing)[:, :, :flen]
    n_chunks = cfg.n_sync_chunks + nb
    if handoff == "complex":
        from .rx import decode_aligned
        cplx = jax.lax.complex(rows[0], rows[1])     # [n_frames, flen]
        out, _ = decode_aligned(cplx, n_chunks=n_chunks,
                                guard_bands=guard_bands,
                                modulation=modulation, cfg=cfg,
                                cfo_estimator="coherent",
                                derot_impl="matrix")
    elif handoff == "split":
        from .rx import _derot_matrix_core
        cp = rows[..., : n_chunks * cfg.sym_len].reshape(
            2, n_frames, n_chunks, cfg.sym_len)
        out, _ = _derot_matrix_core(cp[0], cp[1], n_chunks=n_chunks,
                                    guard_bands=guard_bands,
                                    modulation=modulation, cfg=cfg,
                                    dft_precision=None,
                                    cfo_estimator="coherent")
    else:
        from .rx import decode_planar_matrix
        prows = jnp.swapaxes(rows, 0, 1)             # [n_frames, 2, flen]
        out, _ = decode_planar_matrix(prows, n_chunks=n_chunks,
                                      guard_bands=guard_bands,
                                      modulation=modulation, cfg=cfg,
                                      cfo_estimator="coherent")
    return _fused_defec(out, payload_len, n_bytes, fec)


@_partial(jax.jit, static_argnames=("n_frames", "spacing", "need", "nb",
                                    "flen", "guard_bands", "modulation", "cfg",
                                    "payload_len", "n_bytes", "fec"))
def _extract_and_decode_planar(sp, first, *, n_frames: int, spacing: int,
                               need: int, nb: int, flen: int,
                               guard_bands: bool, modulation: Modulation,
                               cfg: FrameConfig, payload_len: int = 0,
                               n_bytes: int = 0, fec: str | None = None):
    """_extract_and_decode (per-row resync within a one-symbol window) on a
    PLANAR stream f32[2, T]: planar rows feed decode_frame_planar, whose
    fused sync+align kernel consumes the planes directly — the full stream
    is never assembled as complex64 (the complex resync path pays that
    assembly copy before slicing)."""
    from .rx import decode_frame_planar
    sp = jnp.pad(sp, ((0, 0),
                      (0, max(0, need + cfg.sym_len - sp.shape[-1]))))
    rows = jax.lax.dynamic_slice_in_dim(
        sp, first, n_frames * spacing, axis=1)
    rows = jnp.swapaxes(rows.reshape(2, n_frames, spacing), 0, 1)[..., :flen]
    out = decode_frame_planar(rows, n_blocks=nb, guard_bands=guard_bands,
                              modulation=modulation, cfg=cfg,
                              search_window=cfg.sym_len)
    return _fused_defec(out, payload_len, n_bytes, fec)


@_partial(jax.jit, static_argnames=("n_frames", "spacing", "need", "nb",
                                    "flen", "guard_bands", "modulation", "cfg",
                                    "payload_len", "n_bytes", "fec", "resync"))
def _decode_regular_tiled(p, *, n_frames: int, spacing: int, need: int,
                          nb: int, flen: int, guard_bands: bool,
                          modulation: Modulation, cfg: FrameConfig,
                          payload_len: int = 0, n_bytes: int = 0,
                          fec: str | None = None, resync: bool = True):
    """decode_regular body for a pre-tiled PLANAR stream f32[2, tiles, 128]:
    ONE jit graph assembles the complex stream FROM THE TILED PLANES and
    runs the complex sync + extraction.

    Why assemble at all (rather than slicing planes): the planar row
    extraction adds a transpose/interleave copy, while the assembly costs
    one stream write and everything downstream is the complex composition
    that decode_frame runs."""
    s = jax.lax.complex(p[0], p[1]).reshape(-1)
    first = jnp.maximum(
        _first_sync(s, spacing=spacing, need=need, cfg=cfg),
        0).astype(jnp.int32)
    fn = _extract_and_decode if resync else _extract_and_decode_presync
    return fn(s, first, n_frames=n_frames, spacing=spacing, need=need,
              nb=nb, flen=flen, guard_bands=guard_bands,
              modulation=modulation, cfg=cfg, payload_len=payload_len,
              n_bytes=n_bytes, fec=fec)


def decode_regular(samples: jnp.ndarray, *, n_frames: int, spacing: int,
                   payload_len: int, guard_bands: bool = True,
                   modulation: Modulation = Modulation.QPSK,
                   fec: str | None = None, data_len: int | None = None,
                   resync: bool = True,
                   planar_handoff: str = "planar",
                   cfg: FrameConfig = DEFAULT_CONFIG):
    """Decode ``n_frames`` frames at fixed ``spacing`` from one stream.

    samples: complex[T], or a PLANAR f32[2, T] stream (e.g. from
    core.transfer.to_device_planar), or a pre-tiled PLANAR f32[2, tiles, 128]
    stream in the pinned row-major layout (rx.planar_stream_format — the
    zero-copy serving upload; the tile split merges as a free bitcast).  On
    a planar stream no complex copy of the full stream is ever built: the
    presync extractor hands planar rows to the matrix tail directly, and
    the resync extractor hands them to decode_frame_planar's fused kernel.
    The first frame may start anywhere within the first ``spacing`` samples
    (a global sync resolves it).  Returns
    (payloads [n_frames, data_len or payload_len], ok flags).

    ``resync=True`` (default) re-syncs every frame within a one-symbol window
    — robust to sample-clock drift across a long capture.  ``resync=False``
    trusts the global sync and spacing exactly (a transmit loop replaying a
    fixed frame at fixed cadence) and skips the per-row sync/alignment
    entirely — ~17% faster at the 256-frame 64QAM streaming shape.

    ``planar_handoff`` ("planar" | "complex") picks the presync planar
    extractor's intermediate (see _extract_and_decode_presync_planar).
    """
    tiled = (samples.ndim == 3 and samples.shape[0] == 2
             and samples.shape[-1] == 128
             and not jnp.iscomplexobj(samples))
    nb = n_data_blocks(payload_len, modulation, guard_bands, cfg)
    flen = cfg.sync_len + nb * cfg.sym_len
    assert spacing >= flen, f"spacing {spacing} < frame length {flen}"
    need = n_frames * spacing + cfg.sym_len

    if tiled:
        # pre-tiled form [2, tiles, 128] (planar_stream_format): one jit
        # graph assembles the complex stream from the full-sublane tiled
        # planes and runs the complex composition, both resync modes (see
        # _decode_regular_tiled).
        n_bytes = data_len if data_len is not None else payload_len
        out = _decode_regular_tiled(
            samples, n_frames=n_frames, spacing=spacing, need=need, nb=nb,
            flen=flen, guard_bands=guard_bands, modulation=modulation,
            cfg=cfg, payload_len=payload_len, n_bytes=n_bytes,
            fec=fec if fec == "hamming" else None, resync=resync)
        if fec == "hamming":
            return np.asarray(out), np.ones(n_frames, bool)
        raw = np.asarray(out)[:, HEADER_LEN:HEADER_LEN + payload_len]
        return _defec_rows(raw, fec, n_bytes)

    # PLANAR stream input (f32[2, T], e.g. core.transfer.to_device_planar):
    # the extractors run fully planar — no complex copy of the full stream
    # exists in the graph (the rows hand off per ``planar_handoff``).
    planar = (samples.ndim == 2 and samples.shape[0] == 2
              and not jnp.iscomplexobj(samples))

    # One sync for the first frame, then slice periodically.  The sync
    # result STAYS ON DEVICE: pulling it to host (int(...)) would insert a
    # blocking d2h round trip between the two dispatches — a pipeline
    # bubble — so the whole
    # buffer decodes with zero host synchronization until the output fetch.
    if planar:
        first = jnp.maximum(
            _first_sync_planar(samples, spacing=spacing, need=need, cfg=cfg),
            0).astype(jnp.int32)
        if resync:
            fn = _extract_and_decode_planar
        else:
            fn = _partial(_extract_and_decode_presync_planar,
                          handoff=planar_handoff)
    else:
        first = jnp.maximum(
            _first_sync(samples, spacing=spacing, need=need, cfg=cfg),
            0).astype(jnp.int32)
        fn = _extract_and_decode if resync else _extract_and_decode_presync
    n_bytes = data_len if data_len is not None else payload_len
    if fec == "hamming":
        # Hamming decode (bit math) fuses INTO the decode graph: one
        # dispatch demods + corrects every frame, and only the corrected
        # user bytes ever leave the device.
        out = fn(samples, first, n_frames=n_frames,
                 spacing=spacing, need=need, nb=nb, flen=flen,
                 guard_bands=guard_bands, modulation=modulation, cfg=cfg,
                 payload_len=payload_len, n_bytes=n_bytes, fec="hamming")
        return np.asarray(out), np.ones(n_frames, bool)
    out = fn(samples, first, n_frames=n_frames,
             spacing=spacing, need=need, nb=nb, flen=flen,
             guard_bands=guard_bands, modulation=modulation,
             cfg=cfg)
    raw = np.asarray(out)[:, HEADER_LEN:HEADER_LEN + payload_len]
    return _defec_rows(raw, fec, n_bytes)


def _defec_rows(raw: np.ndarray, fec: str | None, n_bytes: int):
    """Host FEC over frame rows: [R, payload_len] -> ([R, n_bytes], ok[R]).
    RS rows decode in ONE batched native call (rs.decode_payload_rows) — the
    per-row decode_stream loop underfilled the codec's 64-block SoA tiles
    and paid one FFI call per frame."""
    if fec is None:
        return raw[:, :n_bytes].copy(), np.ones(raw.shape[0], bool)
    if fec == "rs":
        return rs.decode_payload_rows(raw, n_bytes)
    payloads, oks = [], []
    for r in raw:
        p, ok = _defec(r, fec, n_bytes)
        payloads.append(p)
        oks.append(ok)
    return np.stack(payloads), np.asarray(oks)


@_partial(jax.jit, static_argnames=("n_win", "stride", "cfg"))
def _scan_windows(s, *, n_win: int, stride: int, cfg: FrameConfig):
    """Batched frame detection over the whole stream in ONE dispatch.

    Window i scans candidate frame starts (lags) [i*stride, (i+1)*stride);
    the argmax is masked to that range so a stronger locking block just
    outside it (the next frame's) cannot steal the detection.  Returns
    (lags[n_win] relative to each window, par[n_win]).
    """
    from .. import constants
    from ..ops.xcorr import sliding_correlation
    tdtype = np.complex64 if s.dtype == jnp.complex64 else np.complex128
    template = constants.locking_for(cfg).astype(tdtype)
    k = template.shape[-1]
    wlen = stride + k - 1
    s = jnp.pad(s, (0, max(0, (n_win - 1) * stride + wlen - s.shape[-1])))
    idx = jnp.arange(n_win)[:, None] * stride + jnp.arange(wlen)[None, :]
    w = s[idx]
    c = sliding_correlation(w, template)
    # output index i = lag i-(k-1); keep exactly the in-range lags [0, stride)
    power = jnp.real(c) ** 2 + jnp.imag(c) ** 2
    power = power[..., k - 1: k - 1 + stride]
    # normalized matched filter: rho[L] = |c[L]|^2 / (E_template * E_window[L])
    # is scale-free in [0, 1] (Cauchy-Schwarz), ~= snr/(1+snr) at a true
    # locking block, and ~ln(stride)/k on signal-free or data-only lags —
    # unlike peak-to-average power, it cannot be diluted by frame bodies
    # sharing the window
    e_t = jnp.sum(jnp.abs(jnp.asarray(template)) ** 2).real
    cs = jnp.cumsum(jnp.real(w) ** 2 + jnp.imag(w) ** 2, axis=-1)
    cs = jnp.pad(cs, [(0, 0)] * (cs.ndim - 1) + [(1, 0)])
    e_w = cs[..., k: k + stride] - cs[..., :stride]
    rho = power / (e_t * e_w + 1e-30)
    return jnp.argmax(power, axis=-1) - 1, jnp.max(rho, axis=-1)


@_partial(jax.jit, static_argnames=("n_rows", "nb", "flen", "guard_bands",
                                    "modulation", "cfg"))
def _decode_at_positions(s, pos, *, n_rows: int, nb: int, flen: int,
                         guard_bands: bool, modulation: Modulation,
                         cfg: FrameConfig):
    """Batched aligned decode of ``n_rows`` frames at exact start positions."""
    from .rx import decode_aligned
    s = jnp.pad(s, (0, flen))
    rows = jax.vmap(
        lambda p: jax.lax.dynamic_slice_in_dim(s, p, flen))(pos)
    out, _ = decode_aligned(rows, n_chunks=cfg.n_sync_chunks + nb,
                            guard_bands=guard_bands, modulation=modulation,
                            cfg=cfg, cfo_estimator="coherent",
                            derot_impl="auto")
    return out


def _gate_detections(offs: np.ndarray, pars: np.ndarray, *, t: int,
                     stride: int, flen: int, detection_rho: float,
                     max_frames: int | None, cfg: FrameConfig) -> list[int]:
    """Host-side detection gate + non-max suppression shared by decode_burst
    and its sharded counterpart (parallel.pipeline.decode_burst_sharded)."""
    n_win = offs.shape[-1]
    # off == -1 is the reference's clean-alignment quirk (lag 0): clamp to
    # the window start, like decode() clamps offset -1 to 0
    cand = [(float(pars[i]), int(i * stride + max(int(offs[i]), 0)))
            for i in range(n_win)
            if pars[i] >= detection_rho
            and i * stride + max(int(offs[i]), 0) + flen <= t + cfg.sym_len]
    # non-max suppression by rho: a partial locking-block match at a window
    # tail (the ramp correlates with its own shifted tail) scores above the
    # gate but below the true peak in the next window — strongest-first
    # acceptance keeps the true one, earliest-first would shadow it
    detections: list[int] = []
    for rho, p in sorted(cand, key=lambda c: -c[0]):
        if all(abs(p - q) >= flen for q in detections):
            detections.append(p)
    detections.sort()
    if max_frames is not None:
        detections = detections[:max_frames]
    return detections


def decode_burst(samples, *, payload_len: int, guard_bands: bool = True,
                 modulation: Modulation = Modulation.QPSK,
                 fec: str | None = None, data_len: int | None = None,
                 acquisition: int = 4096, max_frames: int | None = None,
                 detection_rho: float = 0.3,
                 cfg: FrameConfig = DEFAULT_CONFIG) -> list[tuple]:
    """Decode every frame in a stream with arbitrary gaps in TWO dispatches.

    The batched redesign of the ``decode_continuous`` scan loop: instead of
    one host round trip per acquisition window, ALL windows are sync-scanned in one batched dispatch, the host
    applies the normalized-matched-filter gate (``detection_rho``: a true
    locking block scores ~snr/(1+snr), so 0.3 detects down to ~-4 dB SNR;
    data-only windows score ~ln(stride)/80 ~= 0.1) plus a greedy non-overlap
    filter (mirroring the scan loop's skip-past-decoded-frame policy), and
    all detected frames decode in one batched aligned dispatch.  Detection
    counts are bucketed to powers of two so the decode graph compiles
    O(log frames) times total.

    Returns [(position, payload, ok), ...] sorted by position.
    """
    samples = jnp.asarray(samples)
    nb = n_data_blocks(payload_len, modulation, guard_bands, cfg)
    flen = cfg.sync_len + nb * cfg.sym_len
    n_out = data_len if data_len is not None else payload_len
    t = samples.shape[-1]
    if t < flen:
        return []
    # stride <= flen guarantees at most one frame start per window range
    # (frame starts are >= flen apart), so no detection is ever shadowed
    stride = min(acquisition, flen)
    n_win = max(1, -(-(t - flen + 1) // stride))

    offs, pars = _scan_windows(samples, n_win=n_win, stride=stride, cfg=cfg)
    detections = _gate_detections(np.asarray(offs), np.asarray(pars), t=t,
                                  stride=stride, flen=flen,
                                  detection_rho=detection_rho,
                                  max_frames=max_frames, cfg=cfg)
    if not detections:
        return []

    n_rows = 1 << (len(detections) - 1).bit_length()   # power-of-two bucket
    pos = np.asarray(detections + [detections[-1]] * (n_rows - len(detections)),
                     np.int32)
    out = np.asarray(_decode_at_positions(
        samples, jnp.asarray(pos), n_rows=n_rows, nb=nb, flen=flen,
        guard_bands=guard_bands, modulation=modulation, cfg=cfg))

    raw = out[:len(detections), HEADER_LEN:HEADER_LEN + payload_len]
    payloads, oks = _defec_rows(raw, fec, n_out)
    return [(p, payloads[i], bool(oks[i]))
            for i, p in enumerate(detections)]


# Fused jit graphs taking (stream, pos) directly: pad + window slice +
# sync/decode in one computation each, one dispatch per call.  The locking
# template stays a numpy constant inside the trace, so lowering never copies
# a closure-captured device array back to the host.
@_partial(jax.jit, static_argnames=("window", "acquisition", "cfg"))
def _scan_at(s, p, *, window: int, acquisition: int, cfg: FrameConfig):
    from .. import constants
    from ..ops.xcorr import locking_sync_quality
    tdtype = np.complex64 if s.dtype == jnp.complex64 else np.complex128
    template = constants.locking_for(cfg).astype(tdtype)
    padded = jnp.pad(s, (0, window))
    chunk = jax.lax.dynamic_slice_in_dim(padded, p, window)
    return locking_sync_quality(chunk[: acquisition + cfg.sym_len], template)


@_partial(jax.jit, static_argnames=("window", "nb", "guard_bands",
                                    "modulation", "acquisition", "cfg"))
def _dec_at(s, p, *, window: int, nb: int, guard_bands: bool,
            modulation: Modulation, acquisition: int, cfg: FrameConfig):
    padded = jnp.pad(s, (0, window))
    chunk = jax.lax.dynamic_slice_in_dim(padded, p, window)
    return decode_frame(chunk, n_blocks=nb, guard_bands=guard_bands,
                        modulation=modulation, cfg=cfg,
                        search_window=acquisition)


def decode_continuous(samples, *, payload_len: int, guard_bands: bool = True,
                      modulation: Modulation = Modulation.QPSK,
                      fec: str | None = None, data_len: int | None = None,
                      acquisition: int = 4096, max_frames: int | None = None,
                      detection_rho: float = 0.3,
                      cfg: FrameConfig = DEFAULT_CONFIG) -> Iterator[tuple]:
    """Scan a stream for frames of a known size; yield (position, payload, ok).

    Host-driven: after each decoded frame the scan resumes past it.  Frames
    may sit at arbitrary gaps; each acquisition looks at a fixed-size window
    so only two shapes ever compile.  Decode failures advance the window
    rather than aborting (the reference's skip-and-continue policy,
    examples/jetson_rx.rs:87-90).

    ``detection_rho`` is the same normalized-matched-filter gate as
    decode_burst (rho ~= snr/(1+snr) at a true locking block; 0.3 detects
    down to ~-4 dB SNR) — one detection statistic across all scanning paths.
    """
    samples = jnp.asarray(samples)
    nb = n_data_blocks(payload_len, modulation, guard_bands, cfg)
    flen = cfg.sync_len + nb * cfg.sym_len
    window = flen + acquisition
    n_out = data_len if data_len is not None else payload_len

    pos = 0
    found = 0
    t = samples.shape[-1]

    while pos + flen <= t and (max_frames is None or found < max_frames):
        off, rho = _scan_at(samples, jnp.int32(min(pos, t)), window=window,
                            acquisition=acquisition, cfg=cfg)
        off, rho = int(off), float(rho)
        # detection gate: noise-only windows score rho ~ ln(W)/K << 0.3; a
        # real locking block scores ~snr/(1+snr) (Cauchy-Schwarz-bounded)
        if off < 0 or off >= acquisition or rho < detection_rho:
            pos += acquisition  # nothing here; slide the window
            continue
        out = np.asarray(_dec_at(samples, jnp.int32(min(pos, t)),
                                 window=window, nb=nb,
                                 guard_bands=guard_bands,
                                 modulation=modulation,
                                 acquisition=acquisition, cfg=cfg))
        payload = out[HEADER_LEN:HEADER_LEN + payload_len]
        p, ok = _defec(payload, fec, n_out)
        yield pos + off, p, ok
        found += 1
        pos += off + flen
