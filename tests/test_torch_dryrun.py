"""The port's dry run (``launch.dryrun``) and its cost counter
(``launch.cost``) on ``meta`` under a fake process group, against the
reference's specs and ``hlo_parse``.

- For qwen2.5-3b, dbrx-132b and mixtral-8x22b, every runnable shape, on
  both production meshes: the per-device bytes of the parameters, the
  AdamW state and the caches rank 0 holds equal the bytes the
  reference's specs give each device (on a ``jax.sharding.AbstractMesh``).
- A whole cell (qwen2.5-3b decode_32k, single mesh) runs and records,
  its memory analysis included (the caches aliased).
- ``CostCounter``'s dot FLOPs of the reduced qwen2.5-3b's prefill on one
  device are within 1% of ``hlo_parse.analyze`` on the reference's
  CPU-compiled prefill.
- Collective wire bytes follow the ring formulas on a hand-made case.
- Nothing is written under ``benchmarks/results/dryrun/``.
"""
from __future__ import annotations

import math
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import AbstractMesh

from repro.launch import shardings as ref_sh
from repro.launch.hlo_parse import analyze
from repro.models import model as ref_model
from repro.models.config import reduced_for_smoke as ref_reduced
from repro.models.registry import SHAPES
from repro.models.registry import get_arch as ref_get_arch
from repro.optim.adamw import adamw_init as ref_adamw_init
from repro_torch.distributed._collectives import Collectives
from repro_torch.launch import dryrun
from repro_torch.launch.cost import CostCounter, ring_bytes
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import get_arch, reduced_for_smoke
from repro_torch.models.model import Model
from test_torch_temporal import _one_torch_thread  # noqa: F401  (autouse)

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ("qwen2.5-3b", "dbrx-132b", "mixtral-8x22b")
MESHES = {"single": ((16, 16), ("data", "model")),
          "multi": ((2, 16, 16), ("pod", "data", "model"))}


@pytest.fixture(scope="module")
def fake_group():
    """Rank 0 of a fake group (256 ranks, then 512 when asked); torn down
    after the module."""
    yield dryrun.init_fake_group
    if dist.is_initialized():
        dist.destroy_process_group()


def _spec_bytes(shardings, tree, sizes: dict, skip=()) -> int:
    """Bytes each device holds of ``tree`` laid out by ``shardings``."""
    total = 0
    for (path, s), x in zip(
            jax.tree_util.tree_leaves_with_path(
                shardings, is_leaf=lambda v: hasattr(v, "spec")),
            jax.tree.leaves(tree)):
        key = "/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)
        if key in skip:
            continue
        div = 1
        for e in s.spec:
            for a in (e if isinstance(e, tuple) else (e,)):
                div *= sizes[a] if a else 1
        total += math.prod(x.shape) * x.dtype.itemsize // div
    return total


def _reference_bytes(arch: str, shape: str, mesh: str) -> dict:
    shape_, names = MESHES[mesh]
    sizes = dict(zip(names, shape_))
    amesh = AbstractMesh(shape_, names)
    rules = ref_sh.make_sharding_rules(amesh)
    spec = ref_get_arch(arch)
    cfg = spec.config_for(shape)
    params = jax.eval_shape(lambda k: ref_model.init_params(cfg, k),
                            jax.random.key(0))
    out = {"params": _spec_bytes(ref_sh.param_shardings(amesh, rules, params),
                                 params, sizes)}
    kind = SHAPES[shape]["kind"]
    if kind == "train":
        opt = jax.eval_shape(ref_adamw_init, params)
        out["opt"] = _spec_bytes(ref_sh.opt_state_shardings(amesh, rules, opt),
                                 opt, sizes)
    if kind == "decode":
        sh = SHAPES[shape]
        caches = jax.eval_shape(lambda: ref_model.init_cache(
            cfg, sh["global_batch"], sh["seq_len"]))
        # the port's cache length is a Python int, not a leaf
        out["cache"] = _spec_bytes(
            ref_sh.cache_shardings(amesh, rules, caches, cfg.n_kv_heads),
            caches, sizes, skip=("len",))
    return out


CELLS = [(a, s, m) for m in MESHES for a in ARCHS
         for s in ref_get_arch(a).runnable_shapes()]


@pytest.mark.parametrize("arch,shape,mesh", CELLS)
def test_per_device_bytes_equal_the_reference_specs(fake_group, arch, shape, mesh):
    fake_group(512 if mesh == "multi" else 256)
    built = dryrun.build_cell(arch, shape, mesh == "multi")
    assert built["status"] == "built"
    got = dryrun.cell_bytes(built)
    want = _reference_bytes(arch, shape, mesh)
    assert got["params"] == want["params"]
    # the AdamW step counter: a 4-byte scalar in both
    assert got["opt"] == want.get("opt", 0)
    assert got["cache"] == want.get("cache", 0)
    assert got["batch"] > 0


def test_a_cell_runs_and_records(fake_group, tmp_path):
    fake_group(256)
    before = sorted((ROOT / "benchmarks" / "results").rglob("*"))
    failures = dryrun.main(["--arch", "qwen2.5-3b", "--shape", "decode_32k",
                            "--mesh", "single", "--out", str(tmp_path)])
    assert failures == 0
    import json

    rec = json.loads((tmp_path / "qwen2.5-3b__decode_32k__single.json").read_text())
    assert rec["status"] == "ok" and rec["kind"] == "decode"
    assert rec["bytes_per_device"] == dryrun.cell_bytes(
        dryrun.build_cell("qwen2.5-3b", "decode_32k", False))
    assert rec["flops_per_device"] > 0 and rec["hbm_bytes_per_device"] > 0
    # the K/V caches are sequence-sharded (2 kv heads on 16): each
    # layer gathers them
    assert rec["collective_counts"]["all-gather"] > 0
    assert rec["dominant"] in rec["roofline"]
    mem = rec["memory"]
    assert mem["peak_memory_in_bytes"] >= mem["argument_size_in_bytes"]
    assert mem["temp_size_in_bytes"] >= 0
    # the K/V caches are written in place: they are aliased outputs
    assert mem["alias_size_in_bytes"] >= rec["bytes_per_device"]["cache"] > 0
    # the reference's committed records are untouched
    assert sorted((ROOT / "benchmarks" / "results").rglob("*")) == before
    assert dryrun.DEFAULT_OUT == ROOT / "build" / "dryrun_torch"


def test_prefill_flops_match_hlo_parse():
    b, s = 2, 32
    rcfg = ref_reduced(ref_get_arch("qwen2.5-3b").config)
    params = ref_model.init_params(rcfg, jax.random.PRNGKey(0))
    tokens = np.random.default_rng(0).integers(0, rcfg.vocab, (b, s)).astype(np.int32)
    compiled = jax.jit(lambda p, t: ref_model.prefill(p, {"tokens": t}, rcfg, s)) \
        .lower(params, jnp.asarray(tokens)).compile()
    want = analyze(compiled.as_text(), 1)["flops"]
    cfg = reduced_for_smoke(get_arch("qwen2.5-3b").config)
    model = Model(cfg, device="cpu")
    with CostCounter() as c:
        model.prefill({"tokens": tokens}, s)
    got = c.summary()
    # measured: 1.0518528e7 against 1.0559488e7 (0.39% apart)
    assert abs(got["flops"] - want) <= 0.01 * want, (got["flops"], want)
    assert got["collective_bytes"] == 0 and got["collective_counts"] == {}
    assert got["hbm_bytes"] > 0


def test_collective_bytes_follow_the_ring_formulas(fake_group):
    fake_group(256)
    mesh = make_production_mesh(False, device_type="cpu")
    group = mesh.get_group("model")
    g = 16
    ops = torch.ops._c10d_functional
    name = group.group_name
    x = torch.empty((4, 8), device="meta")
    with CostCounter() as c:
        ops.all_gather_into_tensor(x, g, name)                 # out 64x8 f32
        ops.reduce_scatter_tensor(torch.empty((64, 8), device="meta"),
                                  "sum", g, name)              # out 4x8
        ops.all_reduce(x, "sum", name)                         # out 4x8
        ops.all_to_all_single(torch.empty((16, 8), device="meta"),
                              [1] * g, [1] * g, name)          # out 16x8
        # a c10d op (the MoE's exchange), 16x4 f32 as raw bytes
        Collectives(group).all_to_all(torch.empty((16, 4), device="meta"))
    big, small, a2a = 64 * 8 * 4, 4 * 8 * 4, 16 * 8 * 4
    want = (big * (g - 1) / g + small * (g - 1) + 2 * small * (g - 1) / g
            + a2a * (g - 1) / g + 16 * 4 * 4 * (g - 1) / g)
    got = c.summary()
    assert got["collective_bytes"] == pytest.approx(want, rel=1e-12)
    assert got["collective_counts"] == {"all-gather": 1, "all-reduce": 1,
                                        "all-to-all": 2, "reduce-scatter": 1}
    assert ring_bytes("all-reduce", 100.0, 1) == 0.0
