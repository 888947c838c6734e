"""The run's check for JAX compares whole top-level module names."""
import os
import subprocess
import sys

from perfbench.harness import imports, spec


def test_whole_names_are_compared():
    assert imports.forbidden(["repro_torch", "repro_torch.engine", "jaxtyping",
                              "flax_like", "reprolib", "torch"]) == []
    assert imports.forbidden(["repro.core.lopc", "repro_torch"]) == ["repro"]
    assert imports.forbidden(["jax", "jaxlib.xla_client", "flax.linen"]) == [
        "flax", "jax", "jaxlib"]


def test_the_harness_and_program_load_no_jax():
    code = (
        "import sys, json\n"
        "from perfbench.harness import run, spec, imports\n"
        "from perfbench.harness.program import Program\n"
        "c = spec.resolve(spec.load_benchmark(), 'isabel-f32.write')\n"
        "Program(c.config, c.traffic, 'cpu')\n"
        "print(json.dumps(imports.forbidden(sys.modules)))\n")
    env = dict(os.environ, PYTHONPATH=str(spec.ROOT))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=spec.ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"
