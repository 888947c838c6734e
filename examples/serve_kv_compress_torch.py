"""Serving example on the PyTorch/CUDA port: batched decode with
LOPC-compressed KV-cache offload, routed through the micro-batching
compression service.  Every attention layer's K and V block is
submitted at once, the way a multi-request server evicts; the service
coalesces them into shared device batches, restored blocks stay within
the requested error bound, and the drift of a decode on restored K is
reported.

    PYTHONPATH=src python examples/serve_kv_compress_torch.py               # on the GPU
    PYTHONPATH=src python examples/serve_kv_compress_torch.py --device cpu  # plain versions
    PYTHONPATH=src python examples/serve_kv_compress_torch.py --full        # qwen2.5-3b at its published size

The port of ``examples/serve_kv_compress.py`` (it imports neither
``jax`` nor ``repro``): qwen2.5-3b, reduced unless ``--full``, prefills
4 prompts of 48 tokens, and its caches go through ``CompressionService``
at eb 1e-3 absolute on (16, 16, 64) tiles.
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.core import decompress as lopc_decompress
from repro_torch.engine.plan import CompressionPlan
from repro_torch.models import get_arch, reduced_for_smoke
from repro_torch.models.inputs import dummy_batch
from repro_torch.models.model import Model, clone_cache
from repro_torch.service import CompressionService, ServiceConfig

EB = 1e-3
TILE = (16, 16, 64)


def prefill(cfg, device, batch_size: int, prompt_len: int, gen: int):
    """The model (seed 0), the prefill's logits and its caches."""
    model = Model(cfg, seed=0, device=device)
    batch = dummy_batch(cfg, batch_size, prompt_len)
    logits, caches = model.prefill(batch, prompt_len + gen)
    return model, logits, caches


def kv_blocks(caches, cfg) -> dict:
    """Every attention layer's K and V cache as one (B, Hkv*S*D) float32
    block, keyed (slot, "k"|"v", group) as the reference's example keys
    its per-group blocks."""
    period = len(cfg.pattern)
    n_groups = cfg.n_layers // period
    blocks = {}
    for i in range(n_groups * period):
        layer = caches["layers"][i]
        if "attn" not in layer:
            continue
        for kind in ("k", "v"):
            arr = layer["attn"][kind].float().cpu().numpy()
            blocks[(f"slot{i % period}", kind, i // period)] = \
                arr.reshape(arr.shape[0], -1)
    return blocks


def offload(blocks: dict, device, eb: float = EB):
    """All blocks through the service at once: (payloads, restored,
    the service's metrics)."""
    svc_cfg = ServiceConfig(plan=CompressionPlan(tile_shape=TILE),
                            max_delay_ms=10.0, device=str(device))
    with CompressionService(svc_cfg) as svc:
        futs = {key: svc.submit_compress(x, eb, mode="abs")
                for key, x in blocks.items()}
        payloads = {key: f.result() for key, f in futs.items()}
        futs = {key: svc.submit_decompress(b) for key, b in payloads.items()}
        restored = {key: f.result() for key, f in futs.items()}
        m = svc.metrics()
    return payloads, restored, m


def check_offload(blocks, payloads, restored, device, eb: float = EB) -> float:
    """The bound on every block, and each container decoded through the
    plain single-blob API equal to the service's output (the service is
    pure scheduling).  Returns the largest error."""
    kerr = max(float(np.abs(blocks[k] - restored[k]).max()) for k in blocks)
    if kerr > eb:
        raise AssertionError(f"a restored KV block exceeds the bound: "
                             f"{kerr:.3e} > {eb}")
    for key, blob in payloads.items():
        if not np.array_equal(restored[key], lopc_decompress(
                blob, device=device).astype(np.float32)):
            raise AssertionError(f"block {key}: the service's decode differs "
                                 "from core.decompress")
    return kerr


def restored_k(caches, restored, cfg) -> dict:
    """A copy of the caches whose slot-0 K blocks are the restored ones."""
    period = len(cfg.pattern)
    out = clone_cache(caches)
    for (slot, kind, g), x in restored.items():
        if slot != "slot0" or kind != "k":
            continue
        k = out["layers"][g * period]["attn"]["k"]
        out["layers"][g * period]["attn"]["k"] = torch.from_numpy(
            x.reshape(k.shape)).to(k.dtype).to(k.device)
    return out


def decode_drift(model, logits, caches, caches_c, gen: int) -> dict:
    """Greedy decode on the original and the restored caches side by
    side: the largest logit difference and whether the argmax tokens
    agree at every step."""
    tok = logits.argmax(-1)
    drift, same = 0.0, True
    if model.device.type == "cuda":
        torch.cuda.synchronize(model.device)
    t0 = time.perf_counter()
    for _ in range(gen):
        l1, caches = model.decode_step(tok, caches)
        l2, caches_c = model.decode_step(tok, caches_c)
        drift = max(drift, float((l1 - l2).abs().max()))
        same &= bool(torch.equal(l1.argmax(-1), l2.argmax(-1)))
        tok = l1.argmax(-1)
    return {"drift": drift, "same": same, "s": time.perf_counter() - t0}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--full", action="store_true",
                    help="qwen2.5-3b's published config (default: reduced)")
    args = ap.parse_args(argv)

    arch = get_arch("qwen2.5-3b")
    cfg = arch.config if args.full else reduced_for_smoke(arch.config)
    batch_size, prompt_len, gen = 4, 48, 16
    with torch.inference_mode():
        model, logits, caches = prefill(cfg, args.device, batch_size,
                                        prompt_len, gen)
        blocks = kv_blocks(caches, cfg)
        payloads, restored, m = offload(blocks, args.device)
        raw = sum(x.nbytes for x in blocks.values())
        comp = sum(len(b) for b in payloads.values())
        kerr = check_offload(blocks, payloads, restored, args.device)
        print(f"KV offload via service: {len(blocks)} blocks, "
              f"{raw / 1e3:.1f} kB -> {comp / 1e3:.1f} kB "
              f"({raw / comp:.2f}x), max err {kerr:.2e} <= {EB}")
        print(f"  batch occupancy mean {m.mean_batch_occupancy:.1f} / "
              f"max {m.max_batch_occupancy}; "
              f"{m.device_groups} device groups "
              f"({m.mean_device_group_occupancy:.1f} blocks each)")

        d = decode_drift(model, logits, caches,
                         restored_k(caches, restored, cfg), gen)
    print(f"decoded {gen} tokens x {batch_size} reqs in {d['s']:.2f}s "
          f"({gen * batch_size / d['s']:.1f} tok/s total)")
    print(f"max logit drift from compressed KV: {d['drift']:.4f}; "
          f"argmax tokens identical: {d['same']}")


if __name__ == "__main__":
    main()
