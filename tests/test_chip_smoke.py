"""chip_smoke.py's pure parts: the last line, phase selection, the GPU
requirement, and four phases at a tiny size on the CPU (8 virtual devices)."""

import json
import os
import sys

import jax
import jax.numpy as jnp
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke as cs  # noqa: E402

import ofdm_tpu as ot  # noqa: E402


class _Dev:
    platform = "gpu"
    device_kind = "NVIDIA H100 80GB HBM3"


def test_result_line_format():
    line = cs.result_line([_Dev()] * 4)
    assert "\n" not in line
    assert json.loads(line) == {"ok": True, "device": {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 4}}


def test_four_selects_only_its_phase():
    assert cs.selected_phases(True, None) == ("four",)
    assert cs.selected_phases(True, "batched") == ("four",)
    assert cs.selected_phases(False, None) == cs.PHASES
    assert "four" not in cs.PHASES
    assert cs.selected_phases(False, "parity,serving") == ("parity", "serving")
    with pytest.raises(SystemExit):
        cs.selected_phases(False, "nope")


def test_no_gpu_fails_before_any_phase(capsys):
    with pytest.raises(SystemExit) as e:
        cs.main([])
    assert e.value.code not in (0, None)
    assert '"ok"' not in capsys.readouterr().out


@pytest.mark.parametrize("phase", ["roundtrip", "batched", "hamming", "four"])
def test_phase_runs_at_tiny_size(phase, capsys):
    # the four-device phase splits the batch over a 4-way data mesh
    sizes = cs.Sizes(batch=8 if phase == "four" else 2, payload=64,
                     ham_frames=3, ham_bytes=40, steps=1)
    failed = cs.run_phases(cs.Run(jax, jnp, ot, sizes, "cpu"), [phase])
    assert failed == []
    assert f"phase {phase}: ok" in capsys.readouterr().out


def test_trace_dir_traces_the_four_gpu_variants(tmp_path, capsys):
    """--trace-dir: each 4-device variant is traced into its own directory
    (a CPU trace holds no GPU plane, so no kernel lines follow)."""
    sizes = cs.Sizes(batch=8, payload=64, ham_frames=3, ham_bytes=40, steps=1)
    run = cs.Run(jax, jnp, ot, sizes, "cpu", trace_dir=str(tmp_path))
    assert cs.run_phases(run, ["four"]) == []
    out = capsys.readouterr().out
    for name in ("shard_map_align_impl_auto", "shard_map_align_impl_xla",
                 "gspmd_align_impl_xla"):
        assert (tmp_path / f"decode_frame_4_gpus_{name}").is_dir()
    assert out.count("    trace of decode_frame 4 GPUs") == 3
