"""The port's examples (``examples/*_torch.py``) run on the CPU at small
shapes, import neither ``jax`` nor ``repro``, check their own
guarantees (bound, critical points, local order) and print their
reports; without a card their default device refuses to run."""
from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent

_RUN = """
import runpy, sys
sys.argv = sys.argv[1:]
runpy.run_path(sys.argv[0], run_name="__main__")
bad = [m for m in sys.modules if m in ("jax", "repro") or m.startswith(("jax.", "repro."))]
assert not bad, bad
"""


def _run(script: str, *args: str) -> subprocess.CompletedProcess:
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    return subprocess.run(
        [sys.executable, "-c", _RUN, str(ROOT / "examples" / script), *args],
        capture_output=True, text=True, env=env, timeout=300)


@pytest.mark.parametrize("script, args, want", [
    ("quickstart_torch.py", ("--shape", "24,32,32"),
     ["NOA 0.01:", "NOA 0.0001:", "critical points FP/FN/FT = 0/0/0",
      "order violations = 0"]),
    ("scientific_pipeline_torch.py", ("--shape", "16,32,32", "--timesteps", "2"),
     ["t=0:", "t=1:", "(identical to the live field)", "archived"]),
    # the reduced qwen2.5-3b's 2 layers: 4 K and V blocks through the service
    ("serve_kv_compress_torch.py", (),
     ["KV offload via service: 4 blocks,", "<= 0.001", "decoded 16 tokens x 4 reqs",
      "max logit drift from compressed KV:"]),
])
def test_example_runs_on_the_cpu(script, args, want):
    r = _run(script, "--device", "cpu", *args)
    assert r.returncode == 0, r.stderr[-3000:]
    for w in want:
        assert w in r.stdout, r.stdout


SMALL = {"quickstart_torch.py": ("--shape", "8,8,8"),
         "scientific_pipeline_torch.py": ("--shape", "8,8,8", "--timesteps", "1"),
         "serve_kv_compress_torch.py": ()}


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
@pytest.mark.parametrize("script", list(SMALL))
def test_example_defaults_to_the_card(script):
    r = _run(script, *SMALL[script])
    assert r.returncode != 0 and "device='cpu'" in r.stderr
