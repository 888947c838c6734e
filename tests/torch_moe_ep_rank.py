"""One rank of the MoE block's EP check on the card (``chip_smoke.py``
phase 2m (b), ``tests/test_torch_cuda.py``): a gloo group of ``world``
ranks on one GPU, mesh ``data 1 x model world``, mixtral-8x22b's MoE at
width ``d`` x ``d_ff`` (8 experts: EP, ``8 / world`` a rank).

    python tests/torch_moe_ep_rank.py RANK WORLD STORE OUT D D_FF

Every rank draws the whole block from one seed on the card (in turn, to
bound the memory) and keeps its experts.  Rank 0 also runs the world-1
``local_moe`` on the whole block (and, for the aux, on each rank's
block of the sequence).  Case ``f32``: f32 compute, 1 x 8
tokens (no expert can overflow its capacity of 8 in either layout);
case ``bf16``: bf16 compute, 4 x 48 tokens, timed.  Each rank writes
``OUT`` (a ``torch.save``d dict): its local outputs and aux, rank 0 the
world-1 ones, the timings and ``_collectives.COUNTS``.  The collectives
go through ``Collectives`` (gloo: staged through the host)."""
from __future__ import annotations

import math
import statistics
import sys
import time

import torch
import torch.distributed as dist


def main(rank: int, world: int, store: str, out: str, d: int, d_ff: int) -> None:
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    try:
        from torch.distributed.device_mesh import init_device_mesh

        from repro_torch.distributed import _collectives
        from repro_torch.distributed.sharding import P, place, use_sharding_rules
        from repro_torch.launch.shardings import make_sharding_rules, port_param_spec
        from repro_torch.models import get_arch
        from repro_torch.models.moe import MoE

        mesh = init_device_mesh("cuda", (1, world), mesh_dim_names=("data", "model"))
        rules = make_sharding_rules(mesh)
        base = get_arch("mixtral-8x22b").config.scaled(d_model=d, d_ff=d_ff)
        res = {}
        for case, dtype, (b, s) in (("f32", "float32", (1, 8)),
                                    ("bf16", "bfloat16", (4, 48))):
            cfg = base.scaled(dtype=dtype)
            x = torch.randn((b, s, d), generator=torch.Generator(
                device="cuda").manual_seed(1), device="cuda")
            moe = None
            for r in range(world):  # one whole block on the card at a time
                if r == rank:
                    moe = MoE(cfg, torch.Generator(device="cuda").manual_seed(0),
                              "cuda")
                    if rank == 0 and case == "f32":
                        with torch.no_grad():
                            ref, _ = moe(x)
                            # the aux is each rank's over its own tokens,
                            # averaged: the world-1 block's on each block
                            # of the sequence
                            step = s // world
                            aux = [float(moe(x[:, i * step:(i + 1) * step])[1])
                                   for i in range(world)]
                        res["world1"] = (ref.cpu(), sum(aux) / world)
                    for n, p in list(moe.named_parameters()):
                        owner = moe.norm if n.startswith("norm.") else moe
                        spec = port_param_spec(mesh, rules, "layers.0.moe." + n,
                                               p.shape, cfg)
                        owner._parameters[n.split(".")[-1]] = torch.nn.Parameter(
                            place(p.detach(), mesh, spec), requires_grad=False)
                    torch.cuda.empty_cache()
                dist.barrier()
            xs = place(x, mesh, P(("data",), "model"))
            times = []
            with use_sharding_rules(rules), torch.no_grad():
                for rep in range(3 if case == "bf16" else 1):
                    _collectives.reset_counts()
                    dist.barrier()
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    y, aux = moe(xs)
                    torch.cuda.synchronize()
                    times.append(time.perf_counter() - t0)
            res[case] = {"out": y.to_local().float().cpu(),
                         "aux": float(aux.to_local()), "s": times,
                         "collectives": dict(_collectives.COUNTS),
                         "experts_here": tuple(moe.w_gate.to_local().shape)}
            if case == "bf16":
                # the exchange alone: one all_to_all of a slot buffer
                e = cfg.moe.n_experts
                t = b * s // world
                cap = math.ceil(t * cfg.moe.top_k * cfg.moe.capacity_factor / e / 8.0) * 8
                buf = torch.randn((e, cap, d), device="cuda").to(torch.bfloat16)
                comm = _collectives.Collectives(mesh.get_group("model"))
                a2a = []
                for _ in range(3):
                    dist.barrier()
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    comm.all_to_all(buf)
                    torch.cuda.synchronize()
                    a2a.append(time.perf_counter() - t0)
                res[case]["all_to_all_s"] = statistics.median(a2a)
                res[case]["all_to_all_bytes"] = buf.numel() * buf.element_size()
            del moe
            torch.cuda.empty_cache()
        torch.save(res, out)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    a = sys.argv[1:]
    main(int(a[0]), int(a[1]), a[2], a[3], int(a[4]), int(a[5]))
