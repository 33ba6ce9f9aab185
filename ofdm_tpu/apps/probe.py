"""probe: accelerator discovery/diagnostics (the accelerator analog of
examples/probe.rs's USRP probe: enumerate devices, capabilities, memory).
"""

from __future__ import annotations


def main(argv=None):
    import jax

    print(f"jax {jax.__version__}, backend: {jax.default_backend()}")
    print(f"process {jax.process_index()} of {jax.process_count()}")
    devs = jax.devices()
    print(f"{len(devs)} device(s):")
    for d in devs:
        stats = {}
        try:
            stats = d.memory_stats() or {}
        except Exception:
            pass
        line = (f"  [{d.id}] {d.device_kind} platform={d.platform} "
                f"process={d.process_index}")
        if "bytes_limit" in stats:
            line += (f" hbm={stats.get('bytes_in_use', 0) / 1e9:.2f}/"
                     f"{stats['bytes_limit'] / 1e9:.2f} GB")
        coords = getattr(d, "coords", None)
        if coords is not None:
            line += f" coords={coords}"
        print(line)
    try:
        import jax.numpy as jnp
        x = jnp.ones((256, 256))
        (x @ x).block_until_ready()
        print("matmul smoke test: OK")
    except Exception as e:
        print(f"matmul smoke test FAILED: {e}")
        return 1
    return 0


if __name__ == "__main__":
    from ofdm_tpu.apps import run
    run(main)
