"""The live-bytes counter of ``launch.cost`` (the dry run's memory
analysis) and the dry run's ``--all --jobs`` with resume.

- Exact bytes on hand-built programs, on real CPU tensors and on
  ``meta``: a chain of matmuls that frees a temporary, an in-place op, a
  view that outlives its base, the 512-byte rounding and a resize, an
  operand nobody registered, a tensor made outside the dispatcher, a
  DTensor on a fake group of 4 (its local blocks), a gradient and a
  checkpoint's recompute.
- ``meta`` equals real CPU tensors byte for byte (and in FLOPs) on the
  reduced qwen2.5-3b's train step and prefill.
- ``python -m repro_torch.launch.dryrun --all --jobs 2`` runs the two
  cells not yet recorded (one failed, one recorded before the memory
  analysis), one subprocess each, records the six keys, and leaves the
  recorded ones alone.
"""
from __future__ import annotations

import json
from pathlib import Path

import pytest
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor, Shard
from torch.utils.checkpoint import checkpoint

from repro_torch.launch import dryrun
from repro_torch.launch.cost import ALLOC_ROUND, CostCounter
from repro_torch.models import get_arch, reduced_for_smoke
from repro_torch.models.inputs import dummy_batch
from repro_torch.models.model import Model
from repro_torch.models.registry import ARCHITECTURES, SHAPES
from repro_torch.optim.adamw import adamw_init
from repro_torch.runtime.steps import make_train_step
from test_torch_temporal import _one_torch_thread  # noqa: F401  (autouse)

MAT = 64 * 64 * 4  # one (64, 64) f32 matrix: 16384 bytes, a multiple of 512
KEYS = {"argument_size_in_bytes", "output_size_in_bytes", "alias_size_in_bytes",
        "temp_size_in_bytes", "peak_memory_in_bytes",
        "generated_code_size_in_bytes"}


def _mats(device, n=2):
    return [torch.empty(64, 64, device=device) for _ in range(n)]


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_a_chain_of_matmuls_frees_its_temporaries(device):
    a, w = _mats(device)
    with CostCounter(arguments=(a, w)) as c:
        t1 = a @ w          # a, w, t1
        t2 = t1 @ w         # a, w, t1, t2: the peak, 4 matrices
        del t1
        t3 = t2 @ w         # a, w, t2, t3
        del t2
    got = c.memory_analysis(t3)
    assert got["argument_size_in_bytes"] == 2 * MAT
    assert got["peak_memory_in_bytes"] == 4 * MAT
    assert got["output_size_in_bytes"] == MAT and got["alias_size_in_bytes"] == 0
    assert got["temp_size_in_bytes"] == 4 * MAT - 2 * MAT - MAT
    assert got["generated_code_size_in_bytes"] is None
    assert got["generated_code_reason"]
    assert c.memory.live == 3 * MAT  # a, w, t3
    del t3
    assert c.memory.live == 2 * MAT


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_in_place_ops_and_views_add_nothing(device):
    a, w = _mats(device)
    with CostCounter(arguments=(a, w)) as c:
        a.mul_(2.0)
        a.add_(w)
        v = a[:8].T
        u = w.view(-1)[::2]
    got = c.memory_analysis((a, v, u))
    assert got["peak_memory_in_bytes"] == 2 * MAT
    # a, v and u are views of the two argument storages, counted once
    assert got["output_size_in_bytes"] == 2 * MAT == got["alias_size_in_bytes"]
    assert got["temp_size_in_bytes"] == 0


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_a_storage_is_freed_by_its_last_view(device):
    (a,) = _mats(device, 1)
    with CostCounter(arguments=(a,)) as c:
        t = a * 2.0
        v = t[3:5]
        del t
        live_with_view = c.memory.live
        del v
        live_without = c.memory.live
        s = torch.empty(3, device=device)   # 12 bytes take a 512-byte block
        s.resize_(200)                      # 800 bytes take two
    assert live_with_view == 2 * MAT and live_without == MAT
    got = c.memory_analysis(s)
    assert got["output_size_in_bytes"] == 2 * ALLOC_ROUND
    assert got["peak_memory_in_bytes"] == 2 * MAT


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_operands_nobody_registered_and_host_constants(device):
    a, b = _mats(device)
    with CostCounter(arguments=(a,)) as c:
        t = a @ a                          # a, t
        del t
        u = a + b                          # b was alive all along
        k = torch.tensor([1.0, 2.0]).to(device)  # made by this step
    got = c.memory_analysis((u, k))
    # b counts as an argument, live from the start: a, t and b at once,
    # and at the end a, b, u and torch.tensor's host block (on meta also
    # its moved copy): the step's own 512-byte blocks, not arguments
    assert got["argument_size_in_bytes"] == 2 * MAT
    host = ALLOC_ROUND if device == "cpu" else 2 * ALLOC_ROUND
    assert got["peak_memory_in_bytes"] == 3 * MAT + host
    assert got["output_size_in_bytes"] == MAT + ALLOC_ROUND


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_gradients_and_recomputes_are_allocations(device):
    x = torch.empty(64, 64, device=device, requires_grad=True)   # 1 MAT
    w1 = torch.empty(64, 256, device=device)                      # 4 MAT
    w2 = torch.empty(256, 64, device=device)                      # 4 MAT

    def body(t):
        return (t @ w1).relu() @ w2

    with CostCounter(arguments=(x, w1, w2)) as fwd:
        y = checkpoint(body, x, use_reentrant=False).sum()
    # the forward keeps no activation: the loss's block is all
    assert fwd.memory.live == 9 * MAT + ALLOC_ROUND
    # the backward counted alone, from the arguments and the loss
    with CostCounter(arguments=(x, w1, w2, y)) as bwd:
        y.backward()
    got = bwd.memory_analysis(x.grad)
    # the backward recomputes t @ w1 and its relu, 4 matrices each, both
    # live at once: only a counted recompute reaches 17
    assert got["argument_size_in_bytes"] == 9 * MAT + ALLOC_ROUND
    assert got["peak_memory_in_bytes"] >= 17 * MAT
    assert got["output_size_in_bytes"] == MAT and got["alias_size_in_bytes"] == 0
    # FLOPs: the forward's two products, the recompute of the first (it
    # stops once the last saved tensor is packed again), and the two of
    # the backward (neither weight wants a gradient)
    flops = fwd.summary()["flops"] + bwd.summary()["flops"]
    assert flops == 5 * 2 * 64 * 64 * 256


@pytest.fixture()
def fake_group_of_4():
    dryrun.init_fake_group(4)
    yield init_device_mesh("cpu", (4,), mesh_dim_names=("model",))
    dist.destroy_process_group()


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_a_dtensor_counts_its_local_block(fake_group_of_4, device):
    mesh = fake_group_of_4
    block = torch.empty(16, 64, device=device)      # 4096 bytes of (64, 64)
    d = DTensor.from_local(block, mesh, [Shard(0)], run_check=False)
    assert d.shape == (64, 64)
    with CostCounter(arguments=(d,)) as c:
        e = d * 2.0                                 # a new (16, 64) block
        f = e.relu_()                               # in place: nothing
    got = c.memory_analysis((d, f))
    assert got["argument_size_in_bytes"] == 16 * 64 * 4
    assert got["peak_memory_in_bytes"] == 2 * 16 * 64 * 4
    assert got["output_size_in_bytes"] == 2 * 16 * 64 * 4
    assert got["alias_size_in_bytes"] == 16 * 64 * 4


def _qwen_counts(device: str):
    cfg = reduced_for_smoke(get_arch("qwen2.5-3b").config)
    model = Model(cfg, seed=0, device=device)
    opt = adamw_init(dict(model.named_parameters()))
    batch = {k: v.to(device) for k, v in dummy_batch(cfg, 2, 32).items()}
    out = {}
    with CostCounter(arguments=(model, batch)) as c:
        with torch.no_grad():
            result = model.prefill({"tokens": batch["tokens"]}, 32)
    out["prefill"] = (c.memory_analysis(result), c.summary()["flops"])
    del result
    step = make_train_step(cfg, check_finite=False)
    with CostCounter(arguments=(model, opt, batch)) as c:
        result = step(model, opt, batch)
    out["train"] = (c.memory_analysis(result), c.summary()["flops"])
    return out


def test_meta_equals_cpu_tensors_on_the_reduced_qwen():
    cpu, meta = _qwen_counts("cpu"), _qwen_counts("meta")
    assert meta == cpu
    for kind, (mem, flops) in cpu.items():
        assert KEYS <= set(mem) and flops > 0
        assert mem["peak_memory_in_bytes"] > mem["argument_size_in_bytes"]
        assert mem["temp_size_in_bytes"] > 0
    # the train step updates every parameter and moment in place
    train = cpu["train"][0]
    assert train["alias_size_in_bytes"] > 0.99 * train["argument_size_in_bytes"]
    assert cpu["prefill"][0]["alias_size_in_bytes"] == 0


# two of the dry run's quickest cells on the single mesh
JOBS_CELLS = (("mixtral-8x22b", "decode_32k"), ("mixtral-8x22b", "long_500k"))


def test_all_with_jobs_runs_what_is_not_recorded(tmp_path: Path, capsys):
    done = {"status": "ok", "memory": {"peak_memory_in_bytes": 1}}
    for arch in ARCHITECTURES:
        for shape in SHAPES:
            if (arch, shape) not in JOBS_CELLS:
                (tmp_path / f"{arch}__{shape}__single.json").write_text(
                    json.dumps(done))
    # a failed record is run again, and so is an ok one made before the
    # memory analysis
    for (arch, shape), rec in zip(JOBS_CELLS, (
            {"status": "error"},
            {"status": "ok", "memory": {"peak_memory_in_bytes": None}})):
        (tmp_path / f"{arch}__{shape}__single.json").write_text(json.dumps(rec))
    failures = dryrun.main(["--all", "--jobs", "2", "--mesh", "single",
                            "--out", str(tmp_path)])
    assert failures == 0
    assert "2 cells to run" in capsys.readouterr().out
    for arch in ARCHITECTURES:
        for shape in SHAPES:
            rec = json.loads((tmp_path / f"{arch}__{shape}__single.json").read_text())
            if (arch, shape) not in JOBS_CELLS:
                assert rec == done
                continue
            assert rec["status"] == "ok", rec.get("error")
            mem = rec["memory"]
            assert KEYS <= set(mem) and mem["counted_on"] == "meta"
            ints = [mem[k] for k in KEYS - {"generated_code_size_in_bytes"}]
            assert all(isinstance(v, int) for v in ints)
            assert mem["peak_memory_in_bytes"] >= mem["argument_size_in_bytes"]
            assert mem["temp_size_in_bytes"] >= 0
            assert mem["generated_code_size_in_bytes"] is None
            assert mem["generated_code_reason"]
            args = sum(rec["bytes_per_device"].values())
            assert args <= mem["argument_size_in_bytes"]
    # resumed: nothing is left to run
    assert dryrun.main(["--all", "--mesh", "single", "--out", str(tmp_path)]) == 0
    assert "0 cells to run" in capsys.readouterr().out
