"""Multi-pod dry run on ``meta`` (port of ``repro.launch.dryrun``).

Each (arch x shape x mesh) cell builds the model on ``meta`` (shapes, no
values, no memory), places its parameters, optimizer state, batch and
cache with ``launch.shardings`` on the production mesh of a fake process
group of 256 (single) or 512 (multi) ranks made in this process, runs
rank 0's train step, prefill, encode or decode under
``launch.cost.CostCounter``, and records the per-device bytes, the
counted FLOPs, HBM bytes and collective bytes, ``model_flops``, the
roofline terms on an H100 and the memory analysis: the reference's six
``memory_analysis`` keys, counted on ``meta`` by the same pass (their
definitions are ``launch.cost``'s; ``counted_on`` says ``meta``).  The
fake group's collectives move nothing; every op runs on ``meta``.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen2.5-3b --shape train_4k --mesh single
  python -m repro_torch.launch.dryrun --all --jobs 4      # every cell, both meshes
  python -m repro_torch.launch.dryrun --all --mesh multi  # the 2-pod pass only

Records go to ``--out`` (default ``build/dryrun_torch/``), one JSON file
a cell, ``{arch}__{shape}__{mesh}.json``.  ``--all`` runs each cell in
a subprocess of its own, ``--jobs`` at a time, and skips the cells
already recorded ``ok`` or ``skipped`` (so a second run resumes); an
``ok`` record without the memory analysis's peak is run again.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
import traceback
from pathlib import Path

import torch

DEFAULT_OUT = Path(__file__).resolve().parents[3] / "build" / "dryrun_torch"

# NVIDIA H100 80GB HBM3 (SXM, 700 W) datasheet figures
PEAK_FLOPS = 989.4e12     # bf16 dense FLOP/s per GPU
HBM_BW = 3.35e12          # bytes/s per GPU (HBM3)
NVLINK_BW = 450e9         # bytes/s per GPU per direction (NVLink 4, 18 links)



def model_flops(cfg, seq: int, batch: int, kind: str) -> float:
    """MODEL_FLOPS = 6*N*D (dense) / 6*N_active*D (MoE); decode: D=batch."""
    n_active = 0
    d, ff, v = cfg.d_model, cfg.d_ff, cfg.vocab
    hd, hq, hkv = cfg.hd, cfg.n_heads, cfg.n_kv_heads
    for k in cfg.block_kinds:
        if k.startswith("attn"):
            n_active += d * hd * (hq + 2 * hkv) + hq * hd * d  # qkvo
            if cfg.moe is not None:
                mult = 3 if cfg.act.endswith("_glu") else 2
                n_active += cfg.moe.top_k * mult * d * ff
            else:
                mult = 3 if cfg.act.endswith("_glu") else 2
                n_active += mult * d * ff
        elif k == "mamba2":
            d_in = cfg.ssm_expand * d
            n_active += d * (2 * d_in + 2 * cfg.ssm_state + d_in // cfg.ssm_head_dim)
            n_active += d_in * d
        elif k == "rwkv6":
            n_active += 5 * d * d + 2 * d * cfg.d_ff + d * d
    if getattr(cfg, "name", "").startswith("zamba"):
        shared = d * hd * (hq + 2 * hkv) + hq * hd * d + 3 * d * ff
        n_active += shared * (cfg.n_layers // len(cfg.pattern)) // max(cfg.n_layers, 1)
    n_active += d * v  # lm head (+ tied embed)
    tokens = batch * (seq if kind in ("train", "prefill", "encode") else 1)
    mult = 6 if kind == "train" else 2
    return float(mult) * n_active * tokens


def local_bytes(tensors) -> int:
    """Bytes of this rank's blocks of ``tensors`` (DTensors or plain)."""
    total = 0
    for t in tensors:
        if isinstance(t, torch.Tensor):
            t = t.to_local() if hasattr(t, "to_local") else t
            total += t.numel() * t.element_size()
    return total


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    elif isinstance(tree, torch.Tensor):
        yield tree


def init_fake_group(world: int) -> None:
    """A fake process group of ``world`` ranks in this process, as rank 0
    (replacing one of another size)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_world_size() == world and dist.get_backend() == "fake":
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)


def build_cell(arch: str, shape: str, multi_pod: bool, device_type: str = "cpu",
               materialize=None) -> dict:
    """Everything rank 0 holds for a cell, placed on the production mesh
    (its fake group must exist): ``{"status": "skipped", ...}`` or
    ``{"status": "built", "model", "opt", "batch", "caches", "mesh",
    "rules", "cfg", "kind", "seq", "batch_size"}``.  ``materialize``: a
    device on which this rank's blocks are allocated and drawn (else
    everything stays on ``meta``)."""
    from ..launch.mesh import make_production_mesh
    from ..launch.shardings import (
        batch_shardings,
        make_sharding_rules,
        opt_state_shardings,
        param_shardings,
    )
    from ..models.inputs import train_batch_specs
    from ..models.model import Model
    from ..models.registry import SHAPES, get_arch
    from ..optim.adamw import adamw_init

    spec = get_arch(arch)
    if shape in spec.skip_shapes:
        return {"status": "skipped", "reason": spec.skip_shapes[shape]}
    cfg = spec.config_for(shape)
    sh = SHAPES[shape]
    seq, batch, kind = sh["seq_len"], sh["global_batch"], sh["kind"]
    if kind == "prefill" and cfg.encoder_only:
        kind = "encode"
    mesh = make_production_mesh(multi_pod, device_type=device_type)
    rules = make_sharding_rules(mesh)
    model = Model(cfg, device="meta")
    param_shardings(mesh, rules, model, device=materialize)
    dev = torch.device("meta") if materialize is None else torch.device(materialize)

    def make(shape_, dtype):
        dt = getattr(torch, dtype)
        if dev.type == "meta":
            return torch.empty(shape_, dtype=dt, device=dev)
        if dt.is_floating_point:
            return (torch.randn(shape_, device=dev) * 0.02).to(dt)
        return torch.randint(0, cfg.vocab, shape_, dtype=dt, device=dev)

    out = {"status": "built", "model": model, "opt": None, "batch": None,
           "caches": None, "mesh": mesh, "rules": rules, "cfg": cfg,
           "kind": kind, "seq": seq, "batch_size": batch}
    if kind == "decode":
        from ..distributed.sharding import use_sharding_rules

        with use_sharding_rules(rules):
            out["caches"] = model.init_cache(batch, seq)
        out["batch"] = batch_shardings(mesh, rules, {"tokens": make((batch,), "int32")})
        return out
    specs = train_batch_specs(cfg, batch, seq)
    if kind != "train":
        specs.pop("labels", None)
        specs.pop("mask", None)
    out["batch"] = batch_shardings(
        mesh, rules, {k: make(s, d) for k, (s, d) in specs.items()})
    if kind == "train":
        out["opt"] = adamw_init(dict(model.named_parameters()))
        opt_state_shardings(mesh, rules, out["opt"], cfg)
    return out


def run_step(built: dict):
    """Rank 0's step of a built cell."""
    from ..distributed.sharding import use_sharding_rules
    from ..runtime.steps import make_encoder_forward, make_train_step

    model, cfg, kind = built["model"], built["cfg"], built["kind"]
    with use_sharding_rules(built["rules"]):
        if kind == "train":
            step = make_train_step(cfg, check_finite=False)
            return step(model, built["opt"], built["batch"])
        with torch.no_grad():
            if kind == "prefill":
                return model.prefill(built["batch"], built["seq"])
            if kind == "encode":
                return make_encoder_forward(cfg)(model, built["batch"])
            return model.decode_step(built["batch"]["tokens"], built["caches"])


def cell_arguments(built: dict) -> tuple:
    """What rank 0's step of a built cell reads, built before it."""
    return (built["model"], built["opt"], built["batch"], built["caches"])


def cell_bytes(built: dict) -> dict:
    """Per-device bytes of the cell's arguments."""
    model = built["model"]
    return {"params": local_bytes(model.parameters()),
            "opt": local_bytes(_leaves(built["opt"])) if built["opt"] else 0,
            "batch": local_bytes(_leaves(built["batch"])),
            "cache": local_bytes(_leaves(built["caches"])) if built["caches"] else 0}


def roofline(cost: dict) -> tuple[dict, str]:
    """The roofline terms (seconds per device on an H100) of a
    ``CostCounter`` summary, and the dominant one."""
    terms = {"compute_s": cost["flops"] / PEAK_FLOPS,
             "memory_s": cost["hbm_bytes"] / HBM_BW,
             "collective_s": cost["collective_bytes"] / NVLINK_BW}
    return terms, max(terms, key=terms.get)


def run_cell(arch: str, shape: str, mesh_kind: str) -> dict:
    from .cost import CostCounter

    t0 = time.time()
    multi = mesh_kind == "multi"
    n_dev = 512 if multi else 256
    rec = {"arch": arch, "shape": shape, "mesh": mesh_kind}
    init_fake_group(n_dev)
    try:
        built = build_cell(arch, shape, multi)
        if built["status"] == "skipped":
            rec.update(status="skipped", reason=built["reason"])
            return rec
        args = cell_bytes(built)
        with CostCounter(arguments=cell_arguments(built)) as counter:
            result = run_step(built)
        memory = counter.memory_analysis(result)
        del result
    except Exception as e:  # noqa: BLE001
        rec.update(status="error", error=f"{type(e).__name__}: {e}",
                   traceback=traceback.format_exc()[-4000:])
        return rec
    cost = counter.summary()
    cfg = built["cfg"]
    mf = model_flops(cfg, built["seq"], built["batch_size"], built["kind"])
    terms, dominant = roofline(cost)
    rec.update(
        status="ok",
        kind=built["kind"],
        seconds=round(time.time() - t0, 1),
        bytes_per_device=args,
        memory={**memory, "counted_on": "meta"},
        flops_per_device=cost["flops"],
        hbm_bytes_per_device=cost["hbm_bytes"],
        collective_bytes_per_device=cost["collective_bytes"],
        collective_counts=cost["collective_counts"],
        model_flops_total=mf,
        model_flops_per_device=mf / n_dev,
        useful_flop_fraction=(mf / n_dev) / cost["flops"] if cost["flops"] else None,
        roofline=terms,
        dominant=dominant,
        hardware={"gpu": "NVIDIA H100 80GB HBM3", "power_limit_w": 700,
                  "peak_bf16_flops": PEAK_FLOPS, "hbm_bytes_per_s": HBM_BW,
                  "nvlink_bytes_per_s": NVLINK_BW},
    )
    return rec


def _record(out_dir: Path, arch: str, shape: str, mesh: str) -> Path:
    return out_dir / f"{arch}__{shape}__{mesh}.json"


def _status(path: Path):
    """A record's status; ``None`` for none, or for an ``ok`` record made
    before the memory analysis (its peak is not an integer)."""
    try:
        rec = json.loads(path.read_text())
    except (OSError, ValueError):
        return None
    if rec.get("status") == "ok" and not isinstance(
            rec.get("memory", {}).get("peak_memory_in_bytes"), int):
        return None
    return rec.get("status")


def run_all(meshes, out_dir: Path, jobs: int) -> int:
    """Every cell not yet recorded ``ok`` or ``skipped``, one subprocess a
    cell (the fake group of 256/512 ranks is process-wide), ``jobs`` at a
    time; returns the number of cells that failed."""
    from ..models.registry import ARCHITECTURES, SHAPES

    todo = [(a, s, m) for a in ARCHITECTURES for s in SHAPES for m in meshes
            if _status(_record(out_dir, a, s, m)) not in ("ok", "skipped")]
    print(f"{len(todo)} cells to run", flush=True)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(Path(__file__).resolve().parents[2])]
        + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))
    running: list[tuple[subprocess.Popen, tuple]] = []
    failures = 0
    while todo or running:
        while todo and len(running) < jobs:
            arch, shape, m = cell = todo.pop(0)
            cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                   "--arch", arch, "--shape", shape, "--mesh", m,
                   "--out", str(out_dir)]
            running.append((subprocess.Popen(cmd, env=env,
                                             stdout=subprocess.DEVNULL,
                                             stderr=subprocess.DEVNULL), cell))
            print(f"started {arch} {shape} {m}", flush=True)
        time.sleep(0.5)
        still = []
        for proc, cell in running:
            if proc.poll() is None:
                still.append((proc, cell))
                continue
            status = _status(_record(out_dir, *cell)) or "missing"
            failures += status not in ("ok", "skipped")
            print(f"finished {cell} -> {status}", flush=True)
        running = still
    return failures


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", choices=["single", "multi", "both"], default="both")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--jobs", type=int, default=2,
                    help="cells run at a time by --all")
    ap.add_argument("--out", default=str(DEFAULT_OUT))
    args = ap.parse_args(argv)
    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    if args.all:
        failures = run_all(meshes, out_dir, max(1, args.jobs))
        print(f"done; {failures} failures", flush=True)
        return failures
    if not (args.arch and args.shape):
        ap.error("--arch and --shape (or --all)")
    failures = 0
    for m in meshes:  # one fake group a mesh
        rec = run_cell(args.arch, args.shape, m)
        _record(out_dir, args.arch, args.shape, m).write_text(
            json.dumps(rec, indent=2))
        failures += rec["status"] not in ("ok", "skipped")
        print(json.dumps({k: v for k, v in rec.items()
                          if k not in ("traceback", "hardware")}), flush=True)
    return failures


if __name__ == "__main__":
    raise SystemExit(1 if main() else 0)
