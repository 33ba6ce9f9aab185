"""Smoke test of the OFDM receive chain on NVIDIA GPUs.

Drives the main path once through the public entry points at the sizes of
the three deployments the repo benchmarks, and checks every output byte:

  roundtrip  complex64 host -> device -> host transfer, bit-exact
  batched    config 2: 256 rows x 8,192-byte payloads with guard bands, all
             five modulations at their SNR gates, plus one CFO batch
  parity     decode_frame vs the float64 sequential oracle (tests/oracle_rx.py)
             on 4 rows per modulation; the equalized symbols at the default
             DFT precision vs HIGHEST; what each matmul precision lowers to
  hamming    config 4: streaming.decode_regular with Hamming(7,4) FEC over
             256 frames x 4,680 user bytes
  serving    config 5: 390-frame buffers synced and decoded on the device,
             RS(255,223) + colorspace on the host with the native codec
  sync_ab    the sync kernel (kernels/sync_align.py) vs the XLA route:
             offsets and windows, bytes of the full decode_frame, the time
             of each alone and inside decode_frame, and paired times of
             the config-4 and config-5 device steps on each route

``--four`` runs only the four-GPU phase (decode_frame_sharded,
decode_frame_planar_sharded and decode_regular_sharded on a 4-way data mesh;
the pipeline step and decode_frame_timesharded on a 2x2 data x time mesh),
each compared with a single-GPU decode of the same rows.  ``--trace-dir DIR``
also takes profiler traces of the config-2 decode (sync_ab) and the sharded
decode (four) into DIR and prints each GPU's kernel times and idle share.

Every time is a dependency-chained step (each step's carry depends on the
previous step's output) and is printed beside the card's name and power
limit.  The last line of standard output is one JSON object,
{"ok": true, "device": {...}}, printed only when every phase passed.  Without
a GPU, or when a phase fails, the script exits non-zero.

    python chip_smoke.py             # one GPU, every phase
    python chip_smoke.py --four      # four GPUs of one host
    python chip_smoke.py --only sync_ab --trace-dir traces
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import re
import subprocess
import sys
import time
import traceback
from collections import Counter

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

# (modulation, SNR dB) gates at which every byte must decode exactly
GATES = (("BPSK", 30.0), ("QPSK", 30.0), ("QAM16", 35.0), ("QAM64", 45.0),
         ("QAM256", 55.0))
# the CFO batch: this key's per-row CFO draws stay clear of the +-pi/sym_len
# ambiguity bound, where any estimator loses frames
CFO_KEY = 9
PHASES = ("roundtrip", "batched", "parity", "hamming", "serving", "sync_ab")
# decode_frame's two sync routes, in the order the A/B pairs start with
IMPLS = ("xla", "triton")


@dataclasses.dataclass(frozen=True)
class Sizes:
    batch: int = 256            # config 2 rows
    payload: int = 8192         # config 2 payload bytes per row
    ham_frames: int = 256       # config 4
    ham_bytes: int = 4680
    srv_frames: int = 390       # config 5
    srv_side: int = 24          # image frames are side x side pixels
    oracle_rows: int = 4
    ab_slack: int = 512         # sync_ab: random frame delays in [0, slack)
    ab_pairs: int = 10          # sync_ab: timed xla/triton pairs
    steps: int = 20             # timed steps per measurement


def card_info() -> str:
    """Name and power limit of every GPU, as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return "; ".join(line.strip() for line in out.stdout.splitlines()
                     if line.strip())


def result_line(devices) -> str:
    """The last line: the device as JAX reports it."""
    return json.dumps({"ok": True, "device": {
        "platform": devices[0].platform,
        "kind": devices[0].device_kind,
        "count": len(devices)}})


def selected_phases(four: bool, only: str | None) -> tuple[str, ...]:
    if four:
        return ("four",)
    if only:
        names = tuple(only.split(","))
        unknown = set(names) - set(PHASES)
        if unknown:
            raise SystemExit(f"unknown phases {sorted(unknown)}")
        return names
    return PHASES


def require_gpus(jax, count: int):
    devices = jax.devices()
    if devices[0].platform != "gpu":
        raise SystemExit(f"no GPU: JAX found {devices[0].platform} devices")
    if len(devices) < count:
        raise SystemExit(f"need {count} GPUs, JAX found {len(devices)}")
    return devices[:count]


class Run:
    """Shared state of one smoke run: modules, sizes, and the card label."""

    def __init__(self, jax, jnp, ot, sizes: Sizes, label: str,
                 trace_dir: str | None = None):
        self.jax, self.jnp, self.ot, self.sizes = jax, jnp, ot, sizes
        self.label, self.trace_dir = label, trace_dir
        from ofdm_tpu.config import DEFAULT_CONFIG
        self.cfg = DEFAULT_CONFIG

    def say(self, msg: str):
        print(msg, flush=True)

    def timed(self, name: str, step, inputs, n: int | None = None) -> float:
        """ms per step of ``step(x, carry) -> (carry, out)``, chained through
        the carry; prints it beside the card label."""
        jnp = self.jnp
        n = n or self.sizes.steps
        # two warm-up steps: a carry that comes back committed to a device
        # (any step on committed or sharded input) compiles a second time
        c, _ = step(inputs[0], jnp.float32(0.0))
        c, _ = step(inputs[0], c)
        float(c)
        t0 = time.perf_counter()
        for i in range(n):
            c, _ = step(inputs[i % len(inputs)], c)
        float(c)
        ms = (time.perf_counter() - t0) / n * 1e3
        self.say(f"    {name}: {ms:.4f} ms/step over {n} chained steps "
                 f"[{self.label}]")
        return ms

    def traced(self, name: str, step, inputs, n: int | None = None):
        """With a trace directory: a profiler trace of ``n`` chained steps,
        printed as each GPU's largest kernels, busy time and idle share."""
        if not self.trace_dir:
            return
        from ofdm_tpu.obs.profiler import device_breakdown, trace
        jnp = self.jnp
        n = n or self.sizes.steps
        c, _ = step(inputs[0], jnp.float32(0.0))
        c, _ = step(inputs[0], c)
        float(c)
        out = os.path.join(self.trace_dir, re.sub(r"[^a-z0-9]+", "_",
                                                  name.lower()).strip("_"))
        with trace(out):
            for i in range(n):
                c, _ = step(inputs[i % len(inputs)], c)
            float(c)
        self.say(f"    trace of {name}, {n} steps -> {out} [{self.label}]")
        for plane, summ in device_breakdown(out, n).items():
            self.say(f"      {plane}: busy {summ['busy_us_per_step']:.2f} "
                     f"us/step of a {summ['window_us_per_step']:.2f} us "
                     f"window, idle share {summ['idle_share']:.3f}, "
                     f"{summ['launches_per_step']:.1f} kernels/step")
            for kname, us, per in summ["kernels"]:
                self.say(f"        {us:9.2f} us/step x{per:4.1f}  "
                         f"{kname[:100]}")

    def chained(self, fn):
        """jit(step) whose carry depends on fn's output."""
        jax, jnp = self.jax, self.jnp

        @jax.jit
        def step(x, carry):
            out = fn(x)
            return carry + 1.0 + jnp.max(out).astype(jnp.float32) * 1e-9, out
        return step

    def batch(self, mod_name: str, snr: float, key: int, cfo: bool,
              rows: int | None = None, slack: int = 0):
        """Config-2 batch: (data, rx, n_blocks).  ``slack`` > 0 delays each
        row's frame by a random amount below it."""
        jax, jnp, ot, sz = self.jax, self.jnp, self.ot, self.sizes
        mod = ot.Modulation[mod_name]
        rows = rows or sz.batch
        rng = np.random.default_rng(key)
        data = rng.integers(0, 256, (rows, sz.payload), dtype=np.uint8)
        tx = ot.encode(data, guard_bands=True, modulation=mod)
        nb = ot.n_data_blocks(sz.payload, mod, True)
        need = (self.cfg.n_sync_chunks + nb) * self.cfg.sym_len
        if slack:
            delays = rng.integers(0, slack, rows)
            tx = jax.vmap(lambda r, d: jnp.roll(r, d))(
                jnp.pad(tx, ((0, 0), (0, need + slack - tx.shape[-1]))),
                jnp.asarray(delays))
        rx = ot.channel(tx, snr=snr, timing_error=cfo, key=jax.random.key(key))
        rx = jnp.pad(rx, ((0, 0), (0, max(0, need + slack - rx.shape[-1]))))
        return data, jax.block_until_ready(rx), nb

    def decoder(self, mod_name: str, nb: int, **kw):
        ot = self.ot
        mod = ot.Modulation[mod_name]
        return lambda s: ot.decode_frame(s, n_blocks=nb, guard_bands=True,
                                         modulation=mod, **kw)


def byte_errors(out, data, header: int = 16) -> int:
    out = np.asarray(out)
    return int(np.count_nonzero(out[:, header:header + data.shape[1]] != data))


def phase_roundtrip(run: Run):
    jax = run.jax
    from ofdm_tpu.core.transfer import to_device, to_host
    sz = run.sizes
    rng = np.random.default_rng(1)
    n = sz.batch * 19120
    x = (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(
        np.complex64)
    t0 = time.perf_counter()
    d = jax.block_until_ready(to_device(x))
    t1 = time.perf_counter()
    back = to_host(d)
    t2 = time.perf_counter()
    assert d.dtype == np.complex64 and back.dtype == np.complex64
    mismatched = int(np.count_nonzero(back != x))
    run.say(f"    {x.nbytes / 1e6:.1f} MB complex64: {mismatched} mismatched "
            f"samples; h2d {(t1 - t0) * 1e3:.3f} ms, d2h "
            f"{(t2 - t1) * 1e3:.3f} ms [{run.label}]")
    assert mismatched == 0
    # the host-driven parity decode, as `python -m ofdm_tpu.apps.lab3a` runs
    # it; main returns 0 only when errs=0
    from ofdm_tpu.apps import lab3a
    rc = lab3a.main(["--ecc", "--guard-bands", "--cfo"])
    run.say(f"  lab3a --ecc --guard-bands --cfo: rc {rc}")
    assert rc == 0, "lab3a reported byte errors"


def phase_batched(run: Run):
    """Config 2 in all five modulations, plus a CFO batch."""
    for i, (mod, snr) in enumerate(GATES):
        data, rx, nb = run.batch(mod, snr, key=i + 1, cfo=False)
        step = run.chained(run.decoder(mod, nb))
        _, out = step(rx, run.jnp.float32(0.0))
        errs = byte_errors(out, data)
        run.say(f"  {mod} @ {snr:g} dB: {rx.shape[0]} x {rx.shape[1]} "
                f"samples, {errs} byte errors")
        assert errs == 0, f"{mod}: {errs} byte errors"
        run.timed(f"{mod} decode_frame", step, [rx])
    data, rx, nb = run.batch("QAM64", 45.0, key=CFO_KEY, cfo=True)
    step = run.chained(run.decoder("QAM64", nb))
    _, out = step(rx, run.jnp.float32(0.0))
    errs = byte_errors(out, data)
    run.say(f"  QAM64 @ 45 dB with CFO + timing error: {errs} byte errors")
    assert errs == 0, f"CFO batch: {errs} byte errors"
    run.timed("QAM64 decode_frame, CFO batch", step, [rx])


def _precision_lowering(run: Run):
    """Relative error of an f32 matmul at each precision vs float64: about
    1e-3 is TF32, 1e-6 bf16 x3 or TF32 x3, 1e-7 full f32."""
    jax, jnp = run.jax, run.jnp
    rng = np.random.default_rng(2)
    a = rng.standard_normal((2048, 256)).astype(np.float32)
    b = rng.standard_normal((256, 128)).astype(np.float32)
    ref = a.astype(np.float64) @ b.astype(np.float64)
    for name in ("DEFAULT", "HIGH", "HIGHEST"):
        prec = getattr(jax.lax.Precision, name)
        got = np.asarray(jax.jit(lambda x, y: jnp.matmul(
            x, y, precision=prec))(a, b), np.float64)
        err = np.abs(got - ref).max() / np.abs(ref).max()
        run.say(f"    f32 matmul precision {name}: max relative error "
                f"{err:.3g}")


def _hlo_precisions(run: Run, fn, x) -> str:
    """Which precisions and algorithms the compiled program's dots carry."""
    text = run.jax.jit(fn).lower(x).compile().as_text()
    found = Counter(re.findall(r'operand_precision[^\]}]*[\]}]', text))
    found.update(m.group(0) for m in re.finditer(
        r'"algorithm":"[A-Z0-9_]+"|algorithm=[a-z0-9_]+', text))
    return ", ".join(f"{k} x{v}" for k, v in sorted(found.items())) or "none"


def phase_parity(run: Run):
    """Oracle parity on 4 rows per modulation; equalized-symbol error of the
    default DFT precision vs HIGHEST; what the precisions lower to."""
    jax, jnp, ot = run.jax, run.jnp, run.ot
    sys.path.insert(0, HERE)
    from tests.oracle_rx import oracle_decode
    from ofdm_tpu.phy.rx import _planar_align, decode_aligned
    cfg = run.cfg
    rows = run.sizes.oracle_rows
    _precision_lowering(run)
    for i, (mod, snr) in enumerate(GATES):
        data, rx, nb = run.batch(mod, snr, key=i + 1, cfo=False)
        out = np.asarray(jax.jit(run.decoder(mod, nb))(rx))
        rx_h = np.asarray(rx[:rows])
        n = 16 + data.shape[1]      # header + payload; past them a partly
        diff = 0                    # filled last block carries no data
        for r in range(rows):
            want = oracle_decode(rx_h[r], True, mod.lower())
            diff += int(np.count_nonzero(want[:n] != out[r, :n]))
        run.say(f"  {mod}: decode_frame vs float64 oracle on {rows} rows: "
                f"{diff} of {rows * n} header + payload bytes differ")
        assert diff == 0, f"{mod}: {diff} bytes differ from the oracle"

        n_chunks = cfg.n_sync_chunks + nb
        need = n_chunks * cfg.sym_len
        off = jnp.clip(ot.sync_offset(rx, cfg), 0, rx.shape[-1] - need)
        aligned = _planar_align(rx, off, need)
        eq = {}
        for name, prec in (("default", None),
                           ("HIGHEST", jax.lax.Precision.HIGHEST)):
            _, diag = decode_aligned(
                aligned, n_chunks=n_chunks, guard_bands=True,
                modulation=ot.Modulation[mod], cfg=cfg, dft_precision=prec,
                cfo_estimator="coherent", derot_impl="matrix")
            eq[name] = np.asarray(diag["equalized"])
        # constellation levels are odd integers: minimum distance 2
        worst = np.abs(eq["default"] - eq["HIGHEST"]).max() / 2.0
        run.say(f"    equalized symbols, default DFT precision vs HIGHEST: "
                f"max error {worst:.3g} of the minimum distance")
        if mod == "QAM64":
            run.say("    compiled decode_frame dots: "
                    + _hlo_precisions(run, run.decoder(mod, nb), rx))


def _hamming_case(run: Run) -> dict:
    """Config 4: a Hamming(7,4)-coded QAM64 stream of ham_frames frames."""
    jax, jnp, ot, sz, cfg = run.jax, run.jnp, run.ot, run.sizes, run.cfg
    from ofdm_tpu.fec import hamming
    from ofdm_tpu.phy import streaming as st
    mod = ot.Modulation.QAM64
    plen = st.coded_len(sz.ham_bytes, "hamming")
    nb = ot.n_data_blocks(plen, mod, True)
    flen = cfg.sync_len + nb * cfg.sym_len
    need = sz.ham_frames * flen + cfg.sym_len
    rng = np.random.default_rng(4)
    data = rng.integers(0, 256, (sz.ham_frames, sz.ham_bytes), dtype=np.uint8)
    tx = ot.encode(np.asarray(hamming.encode(jnp.asarray(data))),
                   guard_bands=True, modulation=mod)
    s = ot.channel(tx.reshape(-1), snr=45.0, key=jax.random.key(4))
    s = jax.block_until_ready(jnp.pad(s, (0, max(0, need - s.shape[-1]))))
    kw = dict(n_frames=sz.ham_frames, spacing=flen, payload_len=plen,
              guard_bands=True, modulation=mod, fec="hamming",
              data_len=sz.ham_bytes)

    def body(impl: str = "auto"):
        """The device step of decode_regular: global sync, frame rows,
        decode_frame with a bounded scan, Hamming decode."""
        def step(x):
            first = jnp.maximum(st._first_sync(x, spacing=flen, need=need,
                                               cfg=cfg), 0).astype(jnp.int32)
            return st._extract_and_decode(
                x, first, n_frames=sz.ham_frames, spacing=flen, need=need,
                nb=nb, flen=flen, guard_bands=True, modulation=mod, cfg=cfg,
                payload_len=plen, n_bytes=sz.ham_bytes, fec="hamming",
                align_impl=impl)
        return step
    return {"data": data, "stream": s, "kw": kw, "body": body}


def phase_hamming(run: Run):
    """Config 4: Hamming-coded continuous stream."""
    from ofdm_tpu.phy import streaming as st
    sz = run.sizes
    case = _hamming_case(run)
    s, data = case["stream"], case["data"]
    payloads, oks = st.decode_regular(s, **case["kw"])
    errs = int(np.count_nonzero(payloads != data))
    run.say(f"  {sz.ham_frames} frames x {sz.ham_bytes} user bytes "
            f"({s.shape[-1]} samples): {errs} byte errors")
    assert errs == 0 and oks.all(), f"hamming: {errs} byte errors"
    run.timed("decode_regular device step", run.chained(case["body"]()), [s])


def _build_native():
    """Build the native RS codec; the serving phase refuses the numpy one."""
    subprocess.run(["make", "-C", os.path.join(HERE, "native")], check=True,
                   stdout=subprocess.DEVNULL, timeout=600)


def _serving_case(run: Run) -> dict:
    """Config 5: two 390-frame buffers of RS-coded image frames, the second
    with CFO and timing error."""
    jax, jnp, ot, sz, cfg = run.jax, run.jnp, run.ot, run.sizes, run.cfg
    from ofdm_tpu.fec import reed_solomon as rs
    from ofdm_tpu.packets.header import HEADER_LEN
    from ofdm_tpu.phy.streaming import _extract_and_decode, _first_sync
    mod = ot.Modulation.QAM64
    user = sz.srv_side * sz.srv_side
    payload_len = (user // rs.K + 1) * rs.N
    nb = ot.n_data_blocks(payload_len, mod, True)
    flen = cfg.sync_len + nb * cfg.sym_len
    buffer_len = sz.srv_frames * flen + 2 * cfg.sym_len
    need = sz.srv_frames * flen + cfg.sym_len
    rng = np.random.default_rng(5)
    bufs, truth = [], []
    for b in range(2):
        pixels = rng.integers(0, 256, (sz.srv_frames, user), dtype=np.uint8)
        coded = np.stack([rs.encode_stream(p) for p in pixels])
        tx = ot.encode(jnp.asarray(coded), guard_bands=True, modulation=mod)
        stream = jnp.pad(tx.reshape(-1), (0, buffer_len - tx.size))
        bufs.append(jax.block_until_ready(ot.channel(
            stream, snr=45.0, timing_error=(b == 1),
            key=jax.random.key(100 + b))))
        truth.append(pixels)

    def body(impl: str = "auto"):
        """The device step of one buffer: global sync, frame rows,
        decode_frame with a bounded scan, the RS payload bytes."""
        def serve(s):
            first = jnp.maximum(_first_sync(s, spacing=flen, need=need,
                                            cfg=cfg), 0).astype(jnp.int32)
            out = _extract_and_decode(
                s, first, n_frames=sz.srv_frames, spacing=flen, need=need,
                nb=nb, flen=flen, guard_bands=True, modulation=mod, cfg=cfg,
                align_impl=impl)
            return out[:, HEADER_LEN:HEADER_LEN + payload_len]
        return serve
    return {"bufs": bufs, "truth": truth, "user": user, "body": body}


def phase_serving(run: Run):
    """Config 5: buffers decoded on device, RS + colorspace on the host."""
    jnp, sz = run.jnp, run.sizes
    from ofdm_tpu.fec import reed_solomon as rs
    from ofdm_tpu.packets.colors import id_to_rgb
    assert rs._LIB is not None, "native RS codec not loaded (make -C native)"
    run.say(f"  native RS codec: {rs.native_threads()} threads")
    case = _serving_case(run)
    bufs, user = case["bufs"], case["user"]
    step = run.chained(case["body"]())
    for b, s in enumerate(bufs):
        _, raw = step(s, jnp.float32(0.0))
        t0 = time.perf_counter()
        raw = np.asarray(raw)
        t1 = time.perf_counter()
        pixels, ok = rs.decode_payload_rows(raw, user)
        rgb = id_to_rgb(pixels.reshape(-1)).reshape(
            sz.srv_frames, sz.srv_side, sz.srv_side, 3)
        t2 = time.perf_counter()
        errs = int(np.count_nonzero(pixels != case["truth"][b]))
        run.say(f"  buffer {b} ({s.shape[-1]} samples, "
                f"{'CFO' if b else 'no CFO'}): {errs} pixel byte errors, "
                f"{int((~ok).sum())} RS failures, image {rgb.shape}; d2h "
                f"{(t1 - t0) * 1e3:.3f} ms, RS + colorspace "
                f"{(t2 - t1) * 1e3:.3f} ms on {rs.native_threads()} threads "
                f"[{run.label}]")
        assert errs == 0 and ok.all(), f"serving buffer {b}: {errs} errors"
    run.timed("serving device step", step, bufs)


def _window_offsets(planes: np.ndarray, win: np.ndarray, rows) -> dict:
    """For each row, the offset at which ``win`` is a slice of ``planes``."""
    found = {}
    need = win.shape[-1]
    for r in rows:
        hits = [o for o in range(planes.shape[-1] - need + 1)
                if np.array_equal(planes[r, :, o:o + need], win[r])]
        found[r] = hits[0] if hits else None
    return found


def phase_sync_ab(run: Run):
    """Sync kernel vs the XLA route at the config-2 shape."""
    jax, jnp, ot, cfg = run.jax, run.jnp, run.ot, run.cfg
    from ofdm_tpu import constants
    from ofdm_tpu.kernels.sync_align import sync_align, sync_offsets
    from ofdm_tpu.ops.xcorr import sliding_correlation_matmul
    from ofdm_tpu.phy.rx import _planar_align
    data, rx, nb = run.batch("QAM64", 45.0, key=CFO_KEY, cfo=True,
                             slack=run.sizes.ab_slack)
    need = (cfg.n_sync_chunks + nb) * cfg.sym_len
    tpl = constants.locking_for(cfg)
    t = rx.shape[-1]
    off = np.asarray(jnp.clip(ot.sync_offset(rx, cfg), 0, t - need))
    ref = np.asarray(_planar_align(rx, jnp.asarray(off), need))
    planes = jnp.stack([jnp.real(rx), jnp.imag(rx)], axis=1)
    win = np.asarray(jax.jit(lambda p: sync_align(p, tpl, need))(planes))
    ref_planes = np.stack([ref.real, ref.imag], axis=1)
    bad = [r for r in range(rx.shape[0])
           if not np.array_equal(win[r], ref_planes[r])]
    near_tie = 0
    if bad:
        # a near-tie: the kernel's lag carries (to f32 rounding) the same
        # correlation power as the XLA route's
        c = np.asarray(sliding_correlation_matmul(rx, tpl.astype(np.complex64)))
        power = np.abs(c.astype(np.complex128)) ** 2
        got = _window_offsets(np.asarray(planes), win, bad)
        for r in bad:
            o = got[r]
            if o is not None and abs(power[r, o + 1] - power[r, off[r] + 1]) \
                    <= 1e-3 * power[r, off[r] + 1]:
                near_tie += 1
        run.say(f"    rows whose window differs: {bad[:16]} "
                f"(kernel offsets {[got[r] for r in bad[:16]]}, "
                f"XLA offsets {[int(off[r]) for r in bad[:16]]})")
    run.say(f"  kernel vs XLA sync+align on {rx.shape[0]} x {t} samples "
            f"(delays up to {run.sizes.ab_slack}): {len(bad)} rows differ, "
            f"{near_tie} of them near-ties")
    assert len(bad) == near_tie, "kernel windows differ beyond near-ties"

    _, rx2, _ = run.batch("QAM64", 45.0, key=1, cfo=False)
    shape = f"{rx2.shape[0]} x {rx2.shape[1]}"

    def kernel_offsets(s):
        # from the complex stream, like the XLA side: the planar stack the
        # kernel reads is part of its cost
        planes = jnp.stack([jnp.real(s), jnp.imag(s)], axis=1)
        return sync_offsets(planes, tpl, need)
    run.timed(f"sync offsets alone, kernel ({shape})",
              run.chained(kernel_offsets), [rx2])
    run.timed(f"sync offsets alone, XLA ({shape})", run.chained(
        lambda s: ot.sync_offset(s, cfg)), [rx2])

    steps = {impl: run.chained(run.decoder("QAM64", nb, align_impl=impl))
             for impl in IMPLS}
    for impl, step in steps.items():
        errs = byte_errors(step(rx, jnp.float32(0.0))[1], data)
        run.say(f"  decode_frame align_impl={impl}: {errs} byte errors")
        assert errs == 0, f"{impl}: {errs} byte errors"
    _ab(run, f"config 2 decode_frame ({shape})", steps, [rx2])
    for impl, step in steps.items():
        run.traced(f"config 2 decode_frame align_impl={impl}", step, [rx2])

    # the bounded per-frame scans of configs 4 and 5 (search_window = one
    # symbol) give the kernel one short block per row
    ham = _hamming_case(run)
    steps = {impl: run.chained(ham["body"](impl)) for impl in IMPLS}
    for impl, step in steps.items():
        errs = int(np.count_nonzero(np.asarray(
            step(ham["stream"], jnp.float32(0.0))[1]) != ham["data"]))
        run.say(f"  config 4 decode_regular step align_impl={impl}: {errs} "
                f"byte errors")
        assert errs == 0, f"config 4 {impl}: {errs} byte errors"
    _ab(run, "config 4 decode_regular device step", steps, [ham["stream"]])

    srv = _serving_case(run)
    steps = {impl: run.chained(srv["body"](impl)) for impl in IMPLS}
    for b, buf in enumerate(srv["bufs"]):
        outs = [np.asarray(step(buf, jnp.float32(0.0))[1])
                for step in steps.values()]
        diff = int(np.count_nonzero(outs[0] != outs[1]))
        run.say(f"  config 5 buffer {b}: {diff} RS payload bytes differ "
                f"between align_impl={IMPLS[0]} and {IMPLS[1]}")
        assert diff == 0, f"config 5 buffer {b}: {diff} bytes differ"
    _ab(run, "config 5 serving device step", steps, srv["bufs"])


def _ab(run: Run, name: str, steps: dict, inputs) -> dict:
    """Time the two routes of ``steps`` in pairs, alternating which runs
    first; prints the win count and each route's median and quartiles."""
    times = {impl: [] for impl in steps}
    wins = 0
    for i in range(run.sizes.ab_pairs):
        for impl in (IMPLS if i % 2 == 0 else IMPLS[::-1]):
            times[impl].append(run.timed(f"{name}, align_impl={impl}",
                                         steps[impl], inputs))
        wins += times["triton"][-1] < times["xla"][-1]
    quart = {k: np.percentile(v, [25, 50, 75]) for k, v in times.items()}
    run.say(f"  A/B {name} over {run.sizes.ab_pairs} pairs: triton faster "
            f"in {wins}; "
            + ", ".join(f"{k} median {q[1]:.4f} ms (quartiles {q[0]:.4f}-"
                        f"{q[2]:.4f})" for k, q in quart.items())
            + f" [{run.label}]")
    return times


def phase_four(run: Run):
    """Four GPUs: data mesh and data x time mesh vs one GPU."""
    jax, jnp, ot = run.jax, run.jnp, run.ot
    from jax.sharding import NamedSharding, SingleDeviceSharding
    from jax.sharding import PartitionSpec as P
    from ofdm_tpu.parallel.mesh import DATA_AXIS, make_mesh
    from ofdm_tpu.parallel.pipeline import (_rows_sharded,
                                            decode_frame_planar_sharded,
                                            decode_frame_sharded,
                                            decode_regular_sharded,
                                            make_pipeline_step)
    from ofdm_tpu.parallel.timeshard import decode_frame_timesharded
    from ofdm_tpu.phy import streaming as st
    devices = jax.devices()
    qam64 = dict(guard_bands=True, modulation=ot.Modulation.QAM64)
    data, rx, nb = run.batch("QAM64", 45.0, key=CFO_KEY, cfo=True)
    one = jax.device_put(rx, SingleDeviceSharding(devices[0]))
    single = np.asarray(jax.jit(run.decoder("QAM64", nb))(one))
    assert byte_errors(single, data) == 0

    def check_shards(name, arr, n_data):
        """Every card holds its own data shard: rows / n_data of them."""
        held = {s.device.id: s.data.shape for s in arr.addressable_shards}
        run.say(f"    {name}: rows held per device {held}")
        assert len(held) == 4, f"{name}: {len(held)} devices hold shards"
        assert all(shape[0] == arr.shape[0] // n_data
                   for shape in held.values()), f"{name}: uneven shards"

    def check_equal(name, out, want):
        diff = int(np.count_nonzero(np.asarray(out) != want))
        run.say(f"  {name}: {diff} bytes differ from one GPU")
        assert diff == 0, f"{name}: {diff} bytes differ"

    mesh = make_mesh(n_data=4)
    out = decode_frame_sharded(rx, mesh, n_blocks=nb, **qam64)
    check_shards("decode_frame_sharded", out, 4)
    check_equal("decode_frame_sharded, 4-way data mesh", out, single)

    planes = jnp.stack([jnp.real(rx), jnp.imag(rx)], axis=1)
    out = decode_frame_planar_sharded(planes, mesh, n_blocks=nb, **qam64)
    check_shards("decode_frame_planar_sharded", out, 4)
    check_equal("decode_frame_planar_sharded, 4-way data mesh", out, single)

    ham = _hamming_case(run)
    one_gpu, _ = st.decode_regular(ham["stream"], **ham["kw"])
    assert np.array_equal(one_gpu, ham["data"])
    four, oks = decode_regular_sharded(ham["stream"], mesh, **ham["kw"])
    assert oks.all()
    check_equal(f"decode_regular_sharded (config 4, {run.sizes.ham_frames} "
                f"frames), 4-way data mesh", four, one_gpu)

    mesh22 = make_mesh(n_data=2, n_time=2)
    ts = decode_frame_timesharded(rx, mesh22, n_blocks=nb, **qam64)
    check_shards("decode_frame_timesharded", ts, 2)
    check_equal("decode_frame_timesharded, 2x2 mesh", ts, single)

    payload_len = 4096
    step = make_pipeline_step(mesh22, payload_len=payload_len)
    rng = np.random.default_rng(6)
    user = jnp.asarray(rng.integers(0, 256, (run.sizes.batch // 4,
                                             payload_len), dtype=np.uint8))
    decoded, bit_errors = step(user, jax.random.key(6))
    check_shards("make_pipeline_step output", decoded, 2)
    wrong = int(np.count_nonzero(
        np.asarray(decoded)[:, 16:16 + payload_len] != np.asarray(user)))
    run.say(f"  make_pipeline_step, 2x2 mesh: {int(bit_errors)} bit errors, "
            f"{wrong} payload bytes wrong")
    assert int(bit_errors) == 0 and wrong == 0

    # where the 4-GPU step's time goes: shard_map with each sync route, and
    # GSPMD partitioning of decode_frame (XLA route; a pallas_call has no
    # partitioning rule) on the same placed rows
    run.timed("decode_frame, one GPU", run.chained(run.decoder("QAM64", nb)),
              [one])
    rows = NamedSharding(mesh, P(DATA_AXIS, None))
    placed = jax.block_until_ready(jax.device_put(rx, rows))
    variants = {
        f"shard_map align_impl={impl}": run.chained(
            lambda s, impl=impl: _rows_sharded(
                run.decoder("QAM64", nb, align_impl=impl), s, mesh))
        for impl in ("auto", "xla")}
    variants["GSPMD align_impl=xla"] = run.chained(
        run.decoder("QAM64", nb, align_impl="xla"))
    for name, step in variants.items():
        check_equal(f"decode_frame, 4 GPUs, {name}",
                    step(placed, jnp.float32(0.0))[1], single)
    for name, step in variants.items():
        run.timed(f"decode_frame, 4 GPUs, {name}, rows on their GPUs", step,
                  [placed])
    for name, step in variants.items():
        run.traced(f"decode_frame 4 GPUs {name}", step, [placed])
    run.timed("decode_frame_sharded, 4 GPUs, batch scattered from GPU 0 "
              "every step", variants["shard_map align_impl=auto"], [rx])
    t0 = time.perf_counter()
    for _ in range(5):
        jax.block_until_ready(jax.device_put(rx, rows))
    ms = (time.perf_counter() - t0) / 5 * 1e3
    run.say(f"    scatter of the {rx.nbytes / 1e6:.1f} MB batch from GPU 0 to "
            f"the 4-way mesh: {ms:.4f} ms [{run.label}]")


RUNNERS = {"roundtrip": phase_roundtrip, "batched": phase_batched,
           "parity": phase_parity, "hamming": phase_hamming,
           "serving": phase_serving, "sync_ab": phase_sync_ab,
           "four": phase_four}


def run_phases(run: Run, names) -> list[str]:
    """Run each phase, print its outcome; returns the names that failed."""
    failed = []
    for name in names:
        run.say(f"phase {name}")
        t0 = time.perf_counter()
        try:
            RUNNERS[name](run)
        except Exception:
            traceback.print_exc()
            failed.append(name)
        run.say(f"phase {name}: {'FAILED' if name in failed else 'ok'} "
                f"({time.perf_counter() - t0:.1f} s)")
    return failed


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-GPU phase and its comparison")
    ap.add_argument("--only", help="comma-separated subset of " +
                    ",".join(PHASES))
    ap.add_argument("--trace-dir", help="take profiler traces into this "
                    "directory (sync_ab, four)")
    args = ap.parse_args(argv)
    names = selected_phases(args.four, args.only)

    import jax
    devices = require_gpus(jax, 4 if args.four else 1)
    label = card_info()
    print(f"card: {label}", flush=True)
    if "serving" in names:
        _build_native()          # before ofdm_tpu loads the RS codec
    sys.path.insert(0, HERE)
    import jax.numpy as jnp

    import ofdm_tpu as ot
    from ofdm_tpu.core import compile_cache
    print(f"jax {jax.__version__}; XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}"
          f"; compile cache {compile_cache.enable()}", flush=True)

    failed = run_phases(Run(jax, jnp, ot, Sizes(), label, args.trace_dir),
                        names)
    if failed:
        print(f"failed phases: {failed}", file=sys.stderr, flush=True)
        return 1
    print(result_line(devices), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
