"""Command-line apps (``python -m ofdm_tpu.apps.<name>``)."""


def run(main) -> None:
    """Run an app's ``main`` as a program: JAX's persistent compile cache
    first (core/compile_cache.py), then exit with main's return code."""
    from ..core import compile_cache
    compile_cache.enable()
    raise SystemExit(main())
