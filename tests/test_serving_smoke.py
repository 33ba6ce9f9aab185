"""CPU smoke of the end-to-end serving benchmark harness (BASELINE config 5).

Runs tools/exp_serving.py at a tiny shape: feed thread -> double-buffered
upload -> one fused decode dispatch per buffer with >= 2 in flight ->
batched RS de-FEC -> colorspace mapping, gating on every buffer (clean AND
CFO) recovering its transmitted pixels exactly.
"""

import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_serving_harness_end_to_end(tmp_path):
    env = dict(os.environ)
    env.update(SERVE_CPU="1", SERVE_DISTINCT="2", SERVE_ROUNDS="2",
               SERVE_IN_FLIGHT="2", SERVE_FRAMES="6")
    out = subprocess.run(
        [sys.executable, os.path.join(REPO, "tools", "exp_serving.py")],
        env=env, capture_output=True, text=True, timeout=570)
    assert out.returncode == 0, out.stderr[-2000:]
    line = [l for l in out.stdout.splitlines() if l.startswith("RESULTS ")]
    assert line, out.stdout[-2000:]
    res = json.loads(line[0][len("RESULTS "):])
    assert res["buffers"] == 4
    assert res["clean_buffers_ok"] == "2/2"
    assert res["cfo_buffers_ok"] == "2/2"
    assert res["image_frames_per_s"] > 0
