"""Benchmark: configs 2 / 4 / 5 on one NVIDIA GPU.

Prints ONE JSON line whose headline metric is the config-2 aggregate 64QAM
receive-chain throughput (frame sync, CFO, channel estimation, equalization,
pilot phase, demod, packing); `detail.configs` carries the config-4
(Hamming-coded streaming) and config-5 (serving composition with the RS +
colorspace host tail) numbers.  Every result names the device it ran on and
the card's power limit.  Without a GPU the benchmark exits non-zero.

Methodology (docs/BENCHMARKS.md):
- dependency-chained timing: step i's carry depends on step i-1's output
  (+1 per step), so no step can be elided or reordered; fetching the final
  carry forces the whole chain.
- correctness gates every number (decoded payloads byte-equal to tx).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

BATCH = 256
PAYLOAD = 8192
N_INPUTS = 4
REPS = 100

# config 4 (Hamming streaming)
HAM_FRAMES = 256
HAM_DATA_BYTES = 4680
HAM_REPS = 30

# config 5 (serving composition, device-resident buffers)
SRV_DISTINCT = 4
SRV_ROUNDS = 3
SRV_FRAMES = 390          # ~1M samples/buffer keeps pregeneration quick
SRV_IN_FLIGHT = 4
SRV_W = SRV_H = 24
SRV_USER = SRV_W * SRV_H


def _chained(step, inputs, carry, reps):
    """Seconds per step of ``step(x, carry) -> carry`` over ``reps`` chained
    steps; returns (seconds, final carry)."""
    t0 = time.perf_counter()
    for i in range(reps):
        carry = step(inputs[i % len(inputs)], carry)
    float(carry)
    return (time.perf_counter() - t0) / reps, carry


def _tiled_planes(jax, jnp, x, tiles, axis):
    """complex stream(s) -> pre-tiled f32 planes [..., 2, tiles, 128]."""
    t = x.shape[-1]
    p = jnp.stack([jnp.real(x), jnp.imag(x)], axis=axis)
    p = jnp.pad(p, [(0, 0)] * (p.ndim - 1) + [(0, tiles * 128 - t)])
    return jax.block_until_ready(p.reshape(*p.shape[:-1], tiles, 128))


def bench_headline(jax, jnp, ot):
    mod = ot.Modulation.QAM64
    nb = ot.n_data_blocks(PAYLOAD, mod, True)
    frame = 880 + nb * 80

    rng = np.random.default_rng(0)
    datas, rxs = [], []
    for i in range(N_INPUTS):
        d = rng.integers(0, 256, (BATCH, PAYLOAD), dtype=np.uint8)
        tx = ot.encode(d, guard_bands=True, modulation=mod)
        # correctness batch (i=0) has no CFO; the rest exercise the CFO path
        rx = ot.channel(tx, snr=45.0, timing_error=(i > 0),
                        key=jax.random.key(i))
        rx = jnp.pad(rx, ((0, 0), (0, max(0, frame - rx.shape[-1]))))
        datas.append(d)
        rxs.append(jax.block_until_ready(rx))
    n_samples = rxs[0].shape[0] * rxs[0].shape[1]

    decode = jax.jit(lambda s: ot.decode_frame(
        s, n_blocks=nb, guard_bands=True, modulation=mod))

    out0 = jax.block_until_ready(decode(rxs[0]))  # compile + warm
    errs = int(np.count_nonzero(np.asarray(out0)[:, 16:16 + PAYLOAD]
                                != datas[0]))
    assert errs == 0, f"headline: {errs} byte errors"

    @jax.jit
    def step(s, carry):
        out = decode(s)
        return carry + 1.0 + jnp.max(out).astype(jnp.float32) * 1e-9

    carry = step(rxs[0], jnp.float32(0.0))
    float(carry)
    dt, carry = _chained(step, rxs, carry, REPS)

    # planar-input variant: the stream as pre-tiled f32 planes, the form a
    # capture pipeline uploads after deinterleaving fc32 samples
    t = rxs[0].shape[-1]
    tiles = -(-t // 128) + 1
    prxs = [_tiled_planes(jax, jnp, rx, tiles, axis=1) for rx in rxs]
    pdecode = jax.jit(lambda s: ot.decode_frame_planar(
        s, n_blocks=nb, guard_bands=True, modulation=mod))
    perrs = int(np.count_nonzero(
        np.asarray(pdecode(prxs[0]))[:, 16:16 + PAYLOAD] != datas[0]))
    assert perrs == 0, f"planar route: {perrs} byte errors"

    @jax.jit
    def pstep(s, c):
        return c + 1.0 + jnp.max(pdecode(s)).astype(jnp.float32) * 1e-9

    pc = pstep(prxs[0], jnp.float32(0.0))
    float(pc)
    pdt, _ = _chained(pstep, prxs, pc, REPS)

    # single-call blocking latency (forced per call via the carry fetch)
    t1 = time.perf_counter()
    for i in range(5):
        carry = step(rxs[i % N_INPUTS], carry)
        float(carry)
    lat = (time.perf_counter() - t1) / 5

    return {
        "value": n_samples / dt,
        "detail": {
            "batch": BATCH, "frame_samples": int(rxs[0].shape[1]),
            "payload_bytes": PAYLOAD, "byte_errors_clean_batch": errs,
            "seconds_per_step": dt, "blocking_latency_s": lat,
            "planar_input": {"seconds_per_step": pdt,
                             "samples_per_s": n_samples / pdt},
        },
    }


def bench_hamming(jax, jnp, ot):
    """Config 4: Hamming-coded continuous streaming (presync extract)."""
    from ofdm_tpu.config import DEFAULT_CONFIG as cfg
    from ofdm_tpu.fec import hamming
    from ofdm_tpu.phy import streaming as st

    mod = ot.Modulation.QAM64
    plen = st.coded_len(HAM_DATA_BYTES, "hamming")
    nb = ot.n_data_blocks(plen, mod, True)
    flen = cfg.sync_len + nb * cfg.sym_len
    spacing = flen
    need = HAM_FRAMES * spacing + cfg.sym_len

    rng = np.random.default_rng(0)
    datas, streams = [], []
    for i in range(2):
        d = rng.integers(0, 256, (HAM_FRAMES, HAM_DATA_BYTES), dtype=np.uint8)
        coded = hamming.encode(jnp.asarray(d))
        tx = ot.encode(np.asarray(coded), guard_bands=True, modulation=mod)
        s = ot.channel(tx.reshape(-1), snr=45.0, key=jax.random.key(i))
        s = jnp.pad(s, (0, max(0, need - s.shape[-1])))
        datas.append(d)
        streams.append(jax.block_until_ready(s))
    n_samples = HAM_FRAMES * flen

    @jax.jit
    def step(s, carry):
        first = jnp.maximum(
            st._first_sync(s, spacing=spacing, need=need, cfg=cfg),
            0).astype(jnp.int32)
        out = st._extract_and_decode_presync(
            s, first, n_frames=HAM_FRAMES, spacing=spacing, need=need,
            nb=nb, flen=flen, guard_bands=True, modulation=mod, cfg=cfg,
            payload_len=plen, n_bytes=HAM_DATA_BYTES, fec="hamming")
        return carry + 1.0 + jnp.max(out).astype(jnp.float32) * 1e-9, out

    carry, out0 = step(streams[0], jnp.float32(0.0))
    errs = int(np.count_nonzero(np.asarray(out0) != datas[0]))
    assert errs == 0, f"hamming: {errs} byte errors"
    dt, _ = _chained(lambda s, c: step(s, c)[0], streams, carry, HAM_REPS)

    # pre-tiled planar stream f32[2, tiles, 128]: _decode_regular_tiled
    # assembles complex64 from the tiled planes in the same graph
    tiles = -(-streams[0].shape[-1] // 128) + 1
    pstreams = [_tiled_planes(jax, jnp, s, tiles, axis=0) for s in streams]

    @jax.jit
    def pstep(p, carry):
        out = st._decode_regular_tiled(
            p, n_frames=HAM_FRAMES, spacing=spacing, need=need,
            nb=nb, flen=flen, guard_bands=True, modulation=mod, cfg=cfg,
            payload_len=plen, n_bytes=HAM_DATA_BYTES, fec="hamming",
            resync=False)
        return carry + 1.0 + jnp.max(out).astype(jnp.float32) * 1e-9, out

    pc, pout0 = pstep(pstreams[0], jnp.float32(0.0))
    perrs = int(np.count_nonzero(np.asarray(pout0) != datas[0]))
    assert perrs == 0, f"planar streaming route: {perrs} byte errors"
    pdt, _ = _chained(lambda p, c: pstep(p, c)[0], pstreams, pc, HAM_REPS)

    return {
        "metric": "samples/s (64QAM hamming streaming presync)",
        "value": n_samples / dt,
        "unit": "samples/s",
        "detail": {"n_frames": HAM_FRAMES, "frame_samples": flen,
                   "data_bytes": HAM_DATA_BYTES, "wire_bytes": plen,
                   "user_byte_errors_clean_batch": errs,
                   "user_GBps": HAM_FRAMES * HAM_DATA_BYTES / dt / 1e9,
                   "seconds_per_step": dt,
                   "planar_tiled_input": {"seconds_per_step": pdt,
                                          "samples_per_s": n_samples / pdt}},
    }


def bench_serving(jax, jnp, ot):
    """Config 5: sustained serving composition — device-resident buffers,
    >= 4 in flight, host tail = batched RS(255,223) + xterm-256 colorspace.
    Wall-clock includes the host tail; every image frame byte-checked.

    The decode graph slices the RS payload region on device, and per-buffer
    fetches + host tails run on worker threads overlapped with the next
    buffers' dispatches.  A device-resident number (outputs consumed on
    device, no per-buffer fetch) is recorded next to the d2h-included one."""
    import collections
    from concurrent.futures import ThreadPoolExecutor

    from ofdm_tpu.config import DEFAULT_CONFIG as cfg
    from ofdm_tpu.fec import reed_solomon as rs
    from ofdm_tpu.packets.colors import id_to_rgb
    from ofdm_tpu.packets.header import HEADER_LEN
    from ofdm_tpu.phy.streaming import _extract_and_decode, _first_sync

    assert rs._LIB is not None, "native RS codec not loaded (make -C native)"
    mod = ot.Modulation.QAM64
    payload_len = (SRV_USER // rs.K + 1) * rs.N
    nb = ot.n_data_blocks(payload_len, mod, True)
    flen = cfg.sync_len + nb * cfg.sym_len
    spacing = flen
    buffer_len = SRV_FRAMES * spacing + 2 * cfg.sym_len
    need = SRV_FRAMES * spacing + cfg.sym_len

    rng = np.random.default_rng(5)
    pixels = rng.integers(0, 256, (SRV_DISTINCT, SRV_FRAMES, SRV_USER),
                          dtype=np.uint8)
    dev_bufs = []
    for b in range(SRV_DISTINCT):
        coded = np.stack([rs.encode_stream(pixels[b, f])
                          for f in range(SRV_FRAMES)])
        tx = ot.encode(jnp.asarray(coded), guard_bands=True, modulation=mod)
        stream = tx.reshape(-1)
        stream = jnp.pad(stream, (0, buffer_len - stream.shape[-1]))
        dev_bufs.append(jax.block_until_ready(ot.channel(
            stream, snr=45.0, timing_error=(b % 2 == 1),
            key=jax.random.key(100 + b))))
    n_samples = int(dev_bufs[0].size)
    n_buffers = SRV_ROUNDS * SRV_DISTINCT

    @jax.jit
    def serve(s, carry):
        s = s + (carry * np.float32(1e-30)).astype(s.dtype)
        first = jnp.maximum(
            _first_sync(s, spacing=spacing, need=need, cfg=cfg),
            0).astype(jnp.int32)
        out = _extract_and_decode(
            s, first, n_frames=SRV_FRAMES, spacing=spacing, need=need,
            nb=nb, flen=flen, guard_bands=True, modulation=mod, cfg=cfg)
        # device-side payload slice: only the RS code bytes are fetched
        raw = out[:, HEADER_LEN:HEADER_LEN + payload_len]
        return raw, carry + 1.0 + jnp.max(out).astype(jnp.float32) * 1e-9

    def process(raw_np, b_idx):
        data, ok = rs.decode_payload_rows(raw_np, SRV_USER)
        _ = id_to_rgb(data.reshape(-1)).reshape(SRV_FRAMES, SRV_H, SRV_W, 3)
        return bool(ok.all()) and np.array_equal(data, pixels[b_idx])

    def fetch_and_process(o, b_idx):
        return process(np.asarray(o), b_idx)

    carry = jnp.float32(0.0)
    out, carry = serve(dev_bufs[0], carry)     # compile + warm
    t0 = time.perf_counter()
    out_np = np.asarray(out)
    d2h_s = time.perf_counter() - t0           # sliced-payload fetch cost
    assert process(out_np, 0), "serving byte check"

    bad = 0
    futures = collections.deque()
    with ThreadPoolExecutor(max_workers=2) as ex:
        t0 = time.perf_counter()
        for i in range(n_buffers):
            o, carry = serve(dev_bufs[i % SRV_DISTINCT], carry)
            futures.append(ex.submit(fetch_and_process, o, i % SRV_DISTINCT))
            while len(futures) > SRV_IN_FLIGHT:
                bad += not futures.popleft().result()
        while futures:
            bad += not futures.popleft().result()
        dt = (time.perf_counter() - t0) / n_buffers
    assert bad == 0, f"{bad} serving buffers failed byte check"

    # device-resident: outputs consumed on device; the carry chain forces
    # every buffer's full decode
    t0 = time.perf_counter()
    for i in range(n_buffers):
        _, carry = serve(dev_bufs[i % SRV_DISTINCT], carry)
    float(carry)
    dev_dt = (time.perf_counter() - t0) / n_buffers

    gss = n_samples / dt
    return {
        "metric": "sustained samples/s (serving: decode + RS + colorspace)",
        "value": gss,
        "unit": "samples/s",
        "detail": {"frames_per_buffer": SRV_FRAMES,
                   "samples_per_buffer": n_samples,
                   "buffers": n_buffers,
                   "in_flight": SRV_IN_FLIGHT,
                   "image_frames_per_s": SRV_FRAMES / dt,
                   "seconds_per_buffer": dt,
                   "d2h_seconds_per_buffer": d2h_s,
                   "device_resident_seconds_per_buffer": dev_dt,
                   "device_resident_samples_per_s": n_samples / dev_dt,
                   "rs_threads": rs.native_threads()},
    }


def main():
    import jax
    import jax.numpy as jnp

    devices = jax.devices()
    if devices[0].platform != "gpu":
        sys.exit(f"bench.py needs a GPU; JAX found {devices[0].platform}")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()

    # the serving host tail needs the native RS codec; build it before
    # ofdm_tpu loads it
    here = os.path.dirname(os.path.abspath(__file__))
    subprocess.run(["make", "-C", os.path.join(here, "native")], check=True,
                   stdout=subprocess.DEVNULL, timeout=600)

    import ofdm_tpu as ot
    from ofdm_tpu.core import compile_cache
    compile_cache.enable()

    device = {"platform": devices[0].platform, "kind": devices[0].device_kind,
              "count": len(devices), "card": card}
    head = bench_headline(jax, jnp, ot)
    configs = {} if os.environ.get("BENCH_HEADLINE_ONLY") else {
        "hamming_streaming": bench_hamming(jax, jnp, ot),
        "serving": bench_serving(jax, jnp, ot)}
    head["detail"]["configs"] = configs
    print(json.dumps({
        "metric": "samples/s (64QAM demod)",
        "value": head["value"],
        "unit": "samples/s",
        "device": device,
        "detail": head["detail"],
    }))


if __name__ == "__main__":
    main()
