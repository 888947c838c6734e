"""The port's fault-tolerant ``Trainer`` (``repro_torch.runtime.trainer``)
on the CPU: the counterparts of ``tests/test_fault_tolerance.py``'s
trainer tests, checkpoints that resume across the two packages, and the
``launch.train`` CLI and the training example.

Resumes are held to the reference test's ``rtol=2e-5, atol=1e-6``.  The
runs that cross packages compute in f32 (the reduced qwen's bf16
compute differs between the packages in the last bits of bf16 values,
which 7 AdamW steps carry far past that tolerance), and there at most
0.1% of a leaf's elements may miss that tolerance by up to 1e-4
absolute, a third of one step's move at the rate 3e-4: an element
whose gradient lies near AdamW's ``eps`` in the first steps, where the
packages' last-bit gradient differences change its ``m / (sqrt(v) +
eps)`` (measured: 1 element of 8192 in one leaf, off by 1.7e-6, when
the port takes the first 7 steps; none the other way).
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.models.config import reduced_for_smoke as ref_reduced
from repro.models.registry import get_arch as ref_get_arch
from repro.runtime import steps as ref_steps
from repro.runtime.trainer import Trainer as RefTrainer
from repro.runtime.trainer import TrainerConfig as RefTrainerConfig
from repro_torch.checkpoint.manager import restore_tree
from repro_torch.models import get_arch, reduced_for_smoke
from repro_torch.models.convert import params_from_reference
from repro_torch.runtime.trainer import Trainer, TrainerConfig
from test_torch_temporal import _one_torch_thread  # noqa: F401  (autouse)

ROOT = Path(__file__).resolve().parent.parent
RTOL, ATOL = 2e-5, 1e-6
# across packages: the share of a leaf's elements that may miss the
# tolerance, and by how much at most
NEAR_EPS_SHARE, NEAR_EPS_ATOL = 1e-3, 1e-4


def _tiny_cfg(**kw):
    return reduced_for_smoke(get_arch("qwen2.5-3b").config).scaled(**kw)


def _tc(path, **kw):
    base = dict(total_steps=14, ckpt_every=7, ckpt_dir=str(path),
                global_batch=2, seq_len=16)
    return TrainerConfig(**{**base, **kw})


def _misses(a: dict, b: dict) -> tuple[int, int, float]:
    """(the most elements of one leaf outside ``rtol=2e-5, atol=1e-6``,
    that leaf's size, the largest |a - b| among them)."""
    assert set(a) == set(b)
    worst = (0, 1, 0.0)
    for k in a:
        want, got = (np.asarray(x, np.float32) for x in (a[k], b[k]))
        d = np.abs(got.astype(np.float64) - want)
        off = d > ATOL + RTOL * np.abs(want)
        if off.sum() > worst[0]:
            worst = (int(off.sum()), off.size, float(d[off].max()))
    return worst


def _assert_params_close(a: dict, b: dict, near_eps: bool = False) -> None:
    n_off, size, d_max = _misses(a, b)
    if not near_eps:
        assert n_off == 0, (n_off, d_max)
        return
    assert n_off <= NEAR_EPS_SHARE * size, (n_off, size)
    assert d_max <= NEAR_EPS_ATOL, d_max


def _state(model) -> dict:
    return {k: v.numpy() for k, v in model.state_dict().items()}


def test_trainer_resume_is_exact(tmp_path):
    """14 straight steps == 7 steps + preemption + resume (7 more); the
    checkpoint restores the preempted state bit for bit."""
    cfg = _tiny_cfg()
    t1 = Trainer(cfg, _tc(tmp_path / "a"), device="cpu")
    m1, _ = t1.run(0)
    assert t1.state.step == 14 and len(t1.state.losses) == 14

    t2 = Trainer(cfg, _tc(tmp_path / "b", stop_after=7), device="cpu")
    m2, o2 = t2.run(0)
    assert t2.state.step == 7
    saved, step = restore_tree(t2.checkpoint_tree(m2, o2), tmp_path / "b",
                               device="cpu")
    assert step == 6
    want = t2.checkpoint_tree(m2, o2)
    for a, b in zip(jax.tree.leaves(jax.tree.map(lambda t: t.numpy(), want)),
                    jax.tree.leaves(jax.tree.map(lambda t: t.numpy(), saved))):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()

    t3 = Trainer(cfg, _tc(tmp_path / "b"), device="cpu")
    m3, o3 = t3.run(0, resume=True)
    assert t3.state.step == 14 and len(t3.state.losses) == 7
    assert int(o3["step"]) == 14
    _assert_params_close(_state(m1), _state(m3))


def test_trainer_retries_transient_fault(tmp_path):
    cfg = _tiny_cfg()
    boom = {"armed": True}

    def fault(step, attempt):
        if step == 4 and attempt == 0 and boom["armed"]:
            boom["armed"] = False
            raise RuntimeError("injected transient failure")

    t = Trainer(cfg, _tc(tmp_path, total_steps=6, ckpt_every=3, max_retries=2),
                fault_hook=fault, device="cpu")
    t.run(0)
    assert t.state.step == 6
    assert t.state.retries == 1


def test_trainer_restores_after_persistent_faults(tmp_path):
    """A step that fails past ``max_retries`` falls back to the last
    checkpoint and goes on from there; a non-finite loss raises before
    the update and counts as a failure."""
    cfg = _tiny_cfg()
    seen = []

    def fault(step, attempt):
        seen.append((step, attempt))
        if step == 4 and len([s for s in seen if s[0] == 4]) <= 2:
            raise FloatingPointError("non-finite loss")

    t = Trainer(cfg, _tc(tmp_path, total_steps=6, ckpt_every=3, max_retries=1),
                fault_hook=fault, device="cpu")
    t.run(0)
    assert t.state.step == 6 and t.state.retries == 2
    # the restore went back to step 3 (the checkpoint after step 2)
    assert [s for s, a in seen].count(3) == 2


def test_nonfinite_loss_leaves_the_state_untouched():
    from repro_torch.runtime.steps import init_train_state, make_train_step
    from repro_torch.data.pipeline import SyntheticLMStream

    cfg = _tiny_cfg()
    model, opt = init_train_state(cfg, 0, "cpu")
    with torch.no_grad():
        model.final_norm.scale.fill_(float("nan"))
    before = {k: v.clone() for k, v in model.state_dict().items()}
    step = make_train_step(cfg)
    with pytest.raises(FloatingPointError):
        step(model, opt, SyntheticLMStream(cfg, 2, 16).batch_at(0))
    after = model.state_dict()
    for k, v in before.items():
        assert torch.equal(v, after[k]) or torch.isnan(v).all(), k
    assert int(opt["step"]) == 0
    assert all(float(t.abs().sum()) == 0 for t in opt["m"].values())
    assert all(p.grad is None for p in model.parameters())


def test_trainer_straggler_detection(tmp_path):
    cfg = _tiny_cfg()

    def fault(step, attempt):
        if step == 8:
            time.sleep(1.0)  # injected slow host

    t = Trainer(cfg, _tc(tmp_path, total_steps=10, ckpt_every=100,
                         straggler_factor=2.5), fault_hook=fault, device="cpu")
    t.run(0)
    assert t.state.straggler_events >= 1


def test_trainer_loss_decreases_and_logs(tmp_path):
    cfg = _tiny_cfg()
    metrics = tmp_path / "m.jsonl"
    t = Trainer(cfg, _tc(tmp_path / "c", total_steps=30, ckpt_every=100,
                         global_batch=4, seq_len=32, base_lr=1e-3,
                         metrics_path=str(metrics)), device="cpu")
    t.run(1)
    first = np.mean(t.state.losses[:5])
    last = np.mean(t.state.losses[-5:])
    assert last < first - 0.2, (first, last)
    lines = [json.loads(x) for x in metrics.read_text().splitlines()]
    assert [x["step"] for x in lines] == list(range(30))
    assert set(lines[0]) == {"step", "loss", "seconds"}


def test_grad_compression_error_feedback(tmp_path):
    """Compressed training must still reach a similar loss (EF works);
    the error-feedback buffer rides in the checkpoint."""
    cfg = _tiny_cfg()
    kw = dict(total_steps=25, ckpt_every=100, global_batch=4, seq_len=32,
              base_lr=1e-3)
    t_base = Trainer(cfg, _tc(tmp_path / "x", **kw), device="cpu")
    t_base.run(2)
    t_comp = Trainer(cfg, _tc(tmp_path / "y", grad_compression=True, **kw),
                     device="cpu")
    _, opt = t_comp.run(2)
    l_base = np.mean(t_base.state.losses[-5:])
    l_comp = np.mean(t_comp.state.losses[-5:])
    assert l_comp < np.mean(t_comp.state.losses[:5]) - 0.2, "compressed run learns"
    assert abs(l_comp - l_base) < 0.5, (l_base, l_comp)
    assert float(sum(t.abs().sum() for t in opt["ef"].values())) > 0
    manifest = json.loads((tmp_path / "y" / "step_24" / "manifest.json").read_text())
    assert any(leaf["path"].startswith("['opt']['ef']") for leaf in manifest["leaves"])


# ------------------------------------------ checkpoints across packages

def _ref_step_fn(cfg, tc):
    return jax.jit(ref_steps.make_train_step(cfg, base_lr=tc.base_lr,
                                             total_steps=tc.total_steps),
                   donate_argnums=(0, 1))


def cross_package_runs(root: Path) -> dict:
    """The reference's trainer preempted after 7 steps resumed by the
    port's, and the port's by the reference's, each beside the
    reference's 14 straight steps: ``{direction: (final params, the
    reference's)}`` as ``{name: array}``."""
    rcfg = ref_reduced(ref_get_arch("qwen2.5-3b").config).scaled(dtype="float32")
    cfg = _tiny_cfg(dtype="float32")
    base = dict(total_steps=14, ckpt_every=7, global_batch=2, seq_len=16)
    step_fn = _ref_step_fn(rcfg, RefTrainerConfig(**base))
    key = jax.random.PRNGKey(0)

    straight = RefTrainer(rcfg, RefTrainerConfig(ckpt_dir=str(root / "r"),
                                                 **base), step_fn=step_fn)
    p_ref, _ = straight.run(key)
    want = {k: v.numpy() for k, v in params_from_reference(
        jax.tree.map(np.asarray, p_ref), cfg).items()}
    out = {}

    # reference -> port
    RefTrainer(rcfg, RefTrainerConfig(ckpt_dir=str(root / "rp"),
                                      stop_after=7, **base),
               step_fn=step_fn).run(key)
    t = Trainer(cfg, TrainerConfig(ckpt_dir=str(root / "rp"), **base),
                device="cpu")
    model, opt = t.run(0)
    assert t.state.step == 14 and len(t.state.losses) == 7
    assert int(opt["step"]) == 14
    np.testing.assert_allclose(t.state.losses, straight.state.losses[7:],
                               rtol=1e-5)
    out["reference -> port"] = (_state(model), want)

    # port -> reference: the port starts from the reference's init
    init = RefTrainer(rcfg, RefTrainerConfig(ckpt_dir=str(root / "i"), **base))
    r_params, _ = init.init_state(key)
    t = Trainer(cfg, TrainerConfig(ckpt_dir=str(root / "pr"), stop_after=7,
                                   **base), device="cpu")
    model, opt = t.init_state(0)
    model.load_state_dict(params_from_reference(
        jax.tree.map(np.asarray, r_params), cfg))
    t.run(params=model, opt=opt)
    assert t.state.step == 7
    resumed = RefTrainer(rcfg, RefTrainerConfig(ckpt_dir=str(root / "pr"),
                                                **base), step_fn=step_fn)
    p_back, o_back = resumed.run(key, resume=True)
    assert resumed.state.step == 14 and int(o_back["step"]) == 14
    out["port -> reference"] = (
        {k: v.numpy() for k, v in params_from_reference(
            jax.tree.map(np.asarray, p_back), cfg).items()}, want)
    return out


def test_checkpoints_resume_across_packages(tmp_path):
    """Both directions end within the reference test's tolerance of the
    reference's 14 straight steps (but for the near-eps elements)."""
    for got, want in cross_package_runs(tmp_path).values():
        _assert_params_close(want, got, near_eps=True)


# --------------------------------------------------- the CLI and example

def _run(args, timeout=300) -> subprocess.CompletedProcess:
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    return subprocess.run([sys.executable, *args], capture_output=True,
                          text=True, env=env, timeout=timeout, cwd=ROOT)


def test_train_cli_on_the_cpu(tmp_path):
    ck = tmp_path / "ck"
    r = _run(["-m", "repro_torch.launch.train", "--arch", "qwen2.5-3b",
              "--reduced", "--steps", "6", "--ckpt-every", "3", "--device", "cpu",
              "--ckpt-dir", str(ck), "--grad-compression"])
    assert r.returncode == 0, r.stderr[-3000:]
    line = r.stdout.strip().splitlines()[-1]
    assert line.startswith("qwen2.5-3b: 6 steps; loss ") and \
        "retries=0 stragglers=0" in line, r.stdout
    assert (ck / "LATEST").read_text() == "5"
    assert len((tmp_path / "ck.metrics.jsonl").read_text().splitlines()) == 6


def test_training_example_on_the_cpu(tmp_path):
    r = _run([str(ROOT / "examples" / "train_lopc_checkpoints_torch.py"),
              "--device", "cpu", "--steps", "5", "--d-model", "64",
              "--layers", "2", "--vocab", "512", "--seq", "32",
              "--ckpt-dir", str(tmp_path / "ex")])
    assert r.returncode == 0, r.stderr[-3000:]
    assert "model: 0." in r.stdout and "steps 5 | first losses" in r.stdout
    assert "last checkpoint:" in r.stdout and "x)" in r.stdout, r.stdout


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
@pytest.mark.parametrize("args", [
    ["-m", "repro_torch.launch.train", "--arch", "qwen2.5-3b", "--reduced",
     "--steps", "1"],
    [str(ROOT / "examples" / "train_lopc_checkpoints_torch.py"), "--steps", "1"]],
    ids=["cli", "example"])
def test_training_defaults_to_the_card(args, tmp_path):
    r = _run(args + ["--ckpt-dir", str(tmp_path / "ck")])
    assert r.returncode != 0 and "device='cpu'" in r.stderr, r.stderr[-2000:]


if __name__ == "__main__":
    # the measured misses:  PYTHONPATH=src python tests/test_torch_trainer.py
    import tempfile

    torch.set_num_threads(1)
    with tempfile.TemporaryDirectory() as d:
        for name, (got, want) in cross_package_runs(Path(d)).items():
            n_off, size, d_max = _misses(want, got)
            print(f"{name}: {n_off} of {size} elements of one leaf outside "
                  f"rtol={RTOL}, atol={ATOL}, by at most {d_max:.3e}", flush=True)
