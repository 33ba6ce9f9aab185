"""Time-sharded full-chain decode (sequence parallelism, SURVEY.md 5.7).

``sharded_sync_offset`` parallelizes only frame sync; the decode stage of the
round-1 pipeline then gathered whole frame rows across the time axis.  This
module carries sequence parallelism through the ENTIRE receive chain — the
batched replacement for the reference's sequential whole-``Vec`` scan
(src/receiver.rs:36-74):

1. ONE ring halo exchange of ``sym_len - 1`` samples (ppermute)
   serves both the sliding sync correlation (80-tap locking template,
   src/receiver.rs:20-25) and the symbol-boundary spill: after alignment by
   the synced offset, every shard holds complete 80-sample symbols whose
   *starts* fall in its local sample range.
2. The sync offset is resolved with a distributed argmax (pmax/pmin).
3. The 10 sync chunks (locking/preamble/training — src/transmitter.rs:21-34)
   may straddle shards; each shard contributes the chunk samples it owns via
   a one-hot product and a psum assembles them REPLICATED on every shard
   (800 samples/row — tiny).  CFO (src/receiver.rs:231-240) and the LS
   channel estimate (src/receiver.rs:212-229) are then computed replicated,
   which costs less than broadcasting their results.
4. Each shard derotates / CP-strips / DFTs / equalizes / phase-corrects /
   demodulates ONLY its local whole symbols, using the symbol's *global*
   chunk index for the CFO sample counter (src/receiver.rs:44-50).
5. Decoded bytes scatter into [B, n_blocks * bytes_per_block] via a one-hot
   matmul + psum — only decoded BYTES cross shards; the sample axis is never
   all-gathered (asserted on compiled HLO by
   tests/test_parallel.py::test_no_time_axis_allgather).

Byte-identity with the single-device ``decode_frame`` across offsets
straddling shard boundaries is locked by tests/test_timeshard.py.
"""

from __future__ import annotations

from functools import lru_cache, partial

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import NamedSharding, PartitionSpec as P

from .. import constants
from ..config import DEFAULT_CONFIG, FrameConfig
from ..ops.fft import dft_matmul_select, fft
from ..phy.modulation import (BITS_PER_SYMBOL, Modulation,
                              demodulate_symbols_packed)
from ..phy.rx import _cfo_estimate
from .halo import global_argmax
from .mesh import DATA_AXIS, TIME_AXIS


def _bytes_per_block(cfg: FrameConfig, guard_bands: bool,
                     modulation: Modulation) -> int:
    nd = cfg.carriers_per_block(guard_bands)
    bits = nd * BITS_PER_SYMBOL[modulation]
    if bits % 8:
        raise ValueError(
            f"time-sharded decode needs whole-byte blocks: {nd} carriers x "
            f"{BITS_PER_SYMBOL[modulation]} bits/sym = {bits} bits/block")
    return bits // 8


def timesharded_decode_fn(mesh, *, n_blocks: int, guard_bands: bool,
                          modulation: Modulation,
                          cfg: FrameConfig = DEFAULT_CONFIG,
                          cfo_estimator: str = "coherent",
                          search_window: int | None = None,
                          fec: str | None = None,
                          payload_len: int = 0, data_len: int = 0,
                          derot_impl: str = "auto"):
    """Build the shard_map'd decode: complex[B, T] (B over ``data``, T over
    ``time``; T_local a multiple of sym_len) -> uint8[B, n_bytes] replicated
    along ``time``.  Composable inside an enclosing jit (the pipeline step).

    ``search_window`` bounds the sync scan to global frame starts
    < search_window + sym_len, mirroring ``decode_frame``'s truncated-buffer
    acquisition (streaming reacquisition: the frame start is approximately
    known).  Deviation from decode_frame at the window edge only: the
    single-device path's correlation windows see zeros past the truncated
    buffer, while shards see the real stream continuing — a near-peak whose
    80-sample window straddles the boundary can differ.  In-window peaks are
    byte-identical (tests/test_timeshard.py).

    ``fec="hamming"`` runs the SoA Hamming(7,4) tail (fec/hamming.py) on the
    replicated post-psum bytes — BASELINE config 4 riding the time axis; the
    output becomes uint8[B, data_len] corrected user bytes (header stripped).
    The bit math is deterministic and elementwise, so every shard computes
    the same replicated result with zero additional collectives (the HLO
    audit in tests/test_parallel.py stays green).
    """
    if fec not in (None, "hamming"):
        raise ValueError(f"timesharded fec supports None/'hamming', got {fec!r}")
    if fec == "hamming" and not (payload_len and data_len):
        raise ValueError("fec='hamming' needs payload_len and data_len")
    if derot_impl == "auto":
        from ..phy.rx import _DEROT_AUTO
        derot_impl = _DEROT_AUTO
    sym = cfg.sym_len
    n_sync = cfg.n_sync_chunks
    n_chunks = n_sync + n_blocks
    need = n_chunks * sym
    n_time = mesh.shape[TIME_AXIS]
    bpb = _bytes_per_block(cfg, guard_bands, modulation)
    template_c128 = constants.locking_for(cfg)
    k = template_c128.shape[-1]
    if guard_bands:
        sel = tuple(cfg.data_indices) + tuple(cfg.pilot_indices)
        nd = len(cfg.data_indices)
    else:
        sel = None
        nd = cfg.n_fft

    def local_fn(shard):
        b_loc, t_loc = shard.shape
        assert t_loc % sym == 0, f"local shard {t_loc} not a symbol multiple"
        m = t_loc // sym
        t_glob = t_loc * n_time
        assert t_glob >= need, f"stream {t_glob} shorter than frame {need}"
        rd = jnp.real(shard).dtype
        tdtype = np.complex64 if shard.dtype == jnp.complex64 else np.complex128
        template = template_c128.astype(tdtype)

        # --- one halo exchange serves sync windows AND symbol spill -------
        my_t = jax.lax.axis_index(TIME_AXIS)
        halo = sym - 1
        head = shard[:, :halo]
        perm = [(i, (i - 1) % n_time) for i in range(n_time)]
        recv = jax.lax.ppermute(head, TIME_AXIS, perm)
        # the ring wraps the FIRST shard's head to the LAST shard: zero it so
        # windows past the stream end see zeros (= decode_frame's padding)
        recv = jnp.where(my_t == n_time - 1, jnp.zeros_like(recv), recv)
        ext = jnp.concatenate([shard, recv], axis=-1)      # [B, T_loc+sym-1]

        # --- sequence-parallel sync (distributed argmax) -------------------
        from ..ops.xcorr import sliding_correlation
        c = sliding_correlation(ext, template)
        c = c[:, k - 1: k - 1 + t_loc]       # lags s0 .. s0 + T_loc - 1
        power = jnp.real(c) ** 2 + jnp.imag(c) ** 2
        if search_window is not None:
            # decode_frame truncates the scan buffer to W + sym_len samples;
            # zero the out-of-window lags instead (power >= 0, and an
            # all-zero scan ties to the lowest index on both paths)
            pos = my_t * t_loc + jnp.arange(t_loc)
            power = jnp.where(pos[None, :] < search_window + sym,
                              power, jnp.zeros_like(power))
        off = global_argmax(power, TIME_AXIS) - 1          # [B] replicated
        off = jnp.clip(off, 0, t_glob - need)

        # --- local whole-symbol windows ------------------------------------
        # symbol starts are global positions off + c*sym; this shard owns the
        # ones in [s0, s0 + T_loc).  They sit at local positions
        # l0 + i*sym (l0 = (off - s0) mod sym in [0, sym)), i = 0..M-1, and
        # are contiguous back-to-back, so the gather is ONE dynamic slice of
        # M*sym samples per row + reshape (the planar-align trick).
        s0 = (my_t * t_loc).astype(off.dtype)
        d = off - s0
        l0 = jnp.remainder(d, sym)                         # [B] in [0, sym)
        c0 = jnp.floor_divide(d, sym)                      # [B]
        win = jax.vmap(
            lambda row, l: jax.lax.dynamic_slice(row, (l,), (m * sym,)))(
                ext, l0).reshape(b_loc, m, sym)
        # global chunk index of local window i (exact cover: each chunk's
        # start lies in exactly one shard)
        cidx = jnp.arange(m, dtype=off.dtype)[None, :] - c0[:, None]  # [B, M]

        # --- assemble the sync chunks replicated (one-hot + psum) ----------
        oh_sync = (cidx[..., None]
                   == jnp.arange(n_sync, dtype=cidx.dtype)).astype(rd)
        hi = jax.lax.Precision.HIGHEST     # one-hot products must stay exact
        sc_re = jnp.einsum("bms,bmt->bst", oh_sync, jnp.real(win), precision=hi)
        sc_im = jnp.einsum("bms,bmt->bst", oh_sync, jnp.imag(win), precision=hi)
        sync_chunks = jax.lax.complex(jax.lax.psum(sc_re, TIME_AXIS),
                                      jax.lax.psum(sc_im, TIME_AXIS))

        # --- CFO + channel estimate, replicated on every shard --------------
        # (identical math to decode_aligned: phasor outer-product derotation,
        # training DFT at full precision — phy/rx.py decode_aligned)
        f_delta = _cfo_estimate(sync_chunks, cfg, cfo_estimator)    # [B]

        def phasor(angles):
            return jnp.exp(jax.lax.complex(jnp.zeros_like(angles), -angles))

        j_idx = jnp.arange(sym, dtype=rd)
        rot_j = phasor(f_delta[:, None] * j_idx)                    # [B, sym]
        t0 = cfg.n_locking + cfg.n_preamble
        tc_idx = (jnp.arange(t0, t0 + cfg.n_training, dtype=rd)) * sym
        rot_tc = phasor(f_delta[:, None] * tc_idx)                  # [B, n_tr]
        training = sync_chunks[:, t0:t0 + cfg.n_training, :] * \
            (rot_tc[:, :, None] * rot_j[:, None, :]).astype(sync_chunks.dtype)
        training_rx = training[..., cfg.cp_len:]
        training_ref = jnp.asarray(
            constants.training_signals(cfg.n_fft, cfg.training_seed),
            dtype=sync_chunks.dtype)
        h_k = jnp.mean(fft(training_rx) / training_ref, axis=-2)    # [B, n_fft]

        # --- local data symbols: derotate / DFT / equalize / demod ----------
        cf = cidx.astype(rd) * sym
        rot_c = phasor(f_delta[:, None] * cf)                       # [B, M]
        if derot_impl == "matrix":
            # fold the within-symbol phasor into a per-row DFT matrix and
            # the per-chunk phase onto the (small) bin tensor — the local
            # sample shard is read exactly once, by the DFT matmuls (same
            # restructuring as phy/rx.py decode_aligned derot_impl="matrix").
            # The PLANAR form keeps the K-reduction split identical to the
            # single-device _derot_matrix_core, so exactly-boundary symbols
            # (e.g. zero-padded tail bins) round the same way and the
            # byte-identity invariant holds bit-for-bit.
            from ..ops.fft import dft_matmul_select_derot_planar
            data_t = win[..., cfg.cp_len:]                          # [B, M, n_fft]
            sel_all = sel if guard_bands else tuple(range(cfg.n_fft))
            y = dft_matmul_select_derot_planar(
                jnp.real(data_t), jnp.imag(data_t), sel_all, f_delta,
                sample_offset=cfg.cp_len, precision=hi)
            y = y * rot_c[:, :, None].astype(y.dtype)
            if guard_bands:
                eq = y / h_k[..., sel][..., None, :]
                phi = jnp.mean(jnp.angle(eq[..., nd:]), axis=-1,
                               keepdims=True)
                syms = eq[..., :nd] * jnp.exp(
                    -1j * phi.astype(eq.real.dtype)).astype(eq.dtype)
            else:
                syms = y / h_k[..., None, :]
        else:
            data_chunks = win * (rot_c[:, :, None]
                                 * rot_j[:, None, :]).astype(win.dtype)
            data_t = data_chunks[..., cfg.cp_len:]                  # [B, M, n_fft]
            if guard_bands:
                y = dft_matmul_select(data_t, sel, precision=hi)    # [B, M, 52]
                eq = y / h_k[..., sel][..., None, :]
                phi = jnp.mean(jnp.angle(eq[..., nd:]), axis=-1,
                               keepdims=True)
                syms = eq[..., :nd] * jnp.exp(
                    -1j * phi.astype(eq.real.dtype)).astype(eq.dtype)
            else:
                y = fft(data_t)
                syms = y / h_k[..., None, :]
        by = demodulate_symbols_packed(syms, modulation)            # [B, M, bpb]

        # --- scatter decoded bytes into block order (one-hot + psum) --------
        # uint8 values are exact in f32/f64; the scatter is one matmul and the
        # psum moves only n_blocks*bpb bytes/row — never the sample axis.
        oh_data = (cidx[..., None] == (jnp.arange(n_blocks, dtype=cidx.dtype)
                                       + n_sync)).astype(rd)
        out = jnp.einsum("bmk,bmn->bnk", by.astype(rd), oh_data, precision=hi)
        out = jax.lax.psum(out, TIME_AXIS)
        out = out.reshape(b_loc, n_blocks * bpb).astype(jnp.uint8)
        if fec == "hamming":
            # replicated post-psum: pure elementwise uint8 bit math, no
            # further collectives; only corrected user bytes leave the graph
            from ..fec import hamming
            h0 = cfg.header_len_bytes
            out = hamming.decode(out[..., h0:h0 + payload_len], data_len)
        return out

    return shard_map(local_fn, mesh=mesh,
                     in_specs=P(DATA_AXIS, TIME_AXIS),
                     out_specs=P(DATA_AXIS, None))


def channel_timesharded_fn(mesh, *, snr: float | None = 30.0,
                           timing_error: bool = False,
                           cfg: FrameConfig = DEFAULT_CONFIG):
    """Sequence-parallel channel simulator (SURVEY 5.7's overlap-save /
    blockwise convolution mechanism, the dual of the decode halo).

    Build the shard_map'd channel: complex[B, T] (B over ``data``, T over
    ``time``) -> complex[B, T] with the same sharding.  Per shard:

    - 63-sample LEFT halo ppermute completes the multipath convolution
      window (taps length 64, src/channel.rs:26-31); the first shard sees
      zero history — identical to the linear conv's zero-padded start.
      Output is the first T samples of the full conv (the input must carry
      >= 63 samples of zero tail padding, which the pipeline's time-mesh
      padding guarantees, so nothing is lost).
    - CFO rotation uses the GLOBAL sample index (src/channel.rs:48-63);
      the per-row draw folds the data-shard index into the key so all time
      shards of a row agree and data shards stay independent.
    - The noise amplitude's complex pseudo-variance (src/channel.rs:66-71)
      is a global time reduction: two psums (mean, then variance).
    - Noise draws fold (data, time) shard indices into the key: shard-local
      generation, same distribution.  The *realization* therefore differs
      from the single-device ``channel`` (which draws one stream) — a
      documented simulator deviation; the conv/CFO path is byte-identical
      (tests/test_timeshard.py::test_channel_timesharded_conv_matches).

    ``snr=None`` disables noise (test/debug knob).
    """
    n_time = mesh.shape[TIME_AXIS]
    taps_np = constants.CHANNEL_TAPS
    k = taps_np.shape[-1]

    def local_fn(shard, key):
        b_loc, t_loc = shard.shape
        rd = jnp.real(shard).dtype
        taps = jnp.asarray(taps_np, dtype=rd)
        my_t = jax.lax.axis_index(TIME_AXIS)
        my_d = jax.lax.axis_index(DATA_AXIS)

        # left halo: my tail -> right neighbor == receive left's tail
        tail = shard[:, -(k - 1):]
        perm = [(i, (i + 1) % n_time) for i in range(n_time)]
        recv = jax.lax.ppermute(tail, TIME_AXIS, perm)
        recv = jnp.where(my_t == 0, jnp.zeros_like(recv), recv)
        ext = jnp.concatenate([recv, shard], axis=-1)   # [B, k-1 + T_loc]

        from ..ops.convolve import convolve_direct
        full = convolve_direct(ext, taps)               # [B, k-1 + T_loc + k-1]
        out = full[:, k - 1: k - 1 + t_loc]             # global samples owned

        k_cfo, k_noise = jax.random.split(key)
        if timing_error:
            u = jax.random.uniform(jax.random.fold_in(k_cfo, my_d),
                                   (b_loc,), dtype=rd)
            f_delta = jnp.pi * u / 80.0
            n = (my_t * t_loc + jnp.arange(1, t_loc + 1, dtype=rd))
            rot = jnp.exp(1j * (f_delta[:, None] * n[None, :]).astype(out.dtype))
            out = out * rot

        if snr is not None:
            t_glob = t_loc * n_time
            snr_lin = 10.0 ** (snr / 10.0)
            mean = jax.lax.psum(jnp.sum(out, axis=-1), TIME_AXIS) / t_glob
            diff = mean[:, None] - out
            var = jax.lax.psum(jnp.sum(diff * diff, axis=-1),
                               TIME_AXIS) / t_glob
            amp = jnp.sqrt(0.5 * var / snr_lin)
            kk = jax.random.fold_in(jax.random.fold_in(k_noise, my_d), my_t)
            uni = jax.random.uniform(kk, (b_loc, t_loc, 2), dtype=rd,
                                     minval=-1.0, maxval=1.0)
            out = out + amp[:, None] * jax.lax.complex(uni[..., 0],
                                                       uni[..., 1])
        return out

    return shard_map(local_fn, mesh=mesh,
                     in_specs=(P(DATA_AXIS, TIME_AXIS), P()),
                     out_specs=P(DATA_AXIS, TIME_AXIS))


@lru_cache(maxsize=None)
def _jitted(mesh, n_blocks: int, guard_bands: bool, modulation: Modulation,
            cfg: FrameConfig, cfo_estimator: str,
            search_window: int | None = None, fec: str | None = None,
            payload_len: int = 0, data_len: int = 0,
            derot_impl: str = "auto"):
    fn = timesharded_decode_fn(mesh, n_blocks=n_blocks,
                               guard_bands=guard_bands, modulation=modulation,
                               cfg=cfg, cfo_estimator=cfo_estimator,
                               search_window=search_window, fec=fec,
                               payload_len=payload_len, data_len=data_len,
                               derot_impl=derot_impl)
    return jax.jit(fn)


def decode_frame_timesharded(samples: jnp.ndarray, mesh, *, n_blocks: int,
                             guard_bands: bool = False,
                             modulation: Modulation = Modulation.BPSK,
                             cfg: FrameConfig = DEFAULT_CONFIG,
                             cfo_estimator: str = "coherent",
                             search_window: int | None = None,
                             fec: str | None = None,
                             payload_len: int = 0,
                             data_len: int = 0,
                             derot_impl: str = "auto") -> jnp.ndarray:
    """Sequence-parallel batched decode: complex[B, T] -> uint8[B, n_bytes].

    Byte-identical to ``phy.rx.decode_frame`` but with the sample (time) axis
    sharded over the mesh's ``time`` axis and rows over ``data`` — each shard
    decodes only its local whole symbols (the jit is cached per configuration,
    so streaming calls at one deployment shape never retrace).

    ``search_window`` / ``fec`` mirror the streaming decoders: the former
    bounds the sync acquisition to a known reacquisition window, the latter
    fuses the Hamming(7,4) tail in-graph (returns uint8[B, data_len] user
    bytes — byte-identical to ``decode_frame`` + ``fec.hamming.decode``).
    See ``timesharded_decode_fn`` for semantics and deviations.
    """
    samples = jnp.asarray(samples)
    squeeze = samples.ndim == 1
    if squeeze:
        samples = samples[None, :]
    n_time = mesh.shape[TIME_AXIS]
    n_data = mesh.shape[DATA_AXIS]
    assert samples.shape[0] % n_data == 0, (
        f"batch {samples.shape[0]} not divisible by data axis {n_data}")
    need = (cfg.n_sync_chunks + n_blocks) * cfg.sym_len
    quant = n_time * cfg.sym_len
    t_to = -(-max(samples.shape[-1], need) // quant) * quant
    samples = jnp.pad(samples, ((0, 0), (0, t_to - samples.shape[-1])))
    sharded = jax.device_put(
        samples, NamedSharding(mesh, P(DATA_AXIS, TIME_AXIS)))
    out = _jitted(mesh, n_blocks, guard_bands, modulation, cfg,
                  cfo_estimator, search_window, fec, payload_len,
                  data_len, derot_impl)(sharded)
    return out[0] if squeeze else out
