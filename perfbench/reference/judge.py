"""The comparison that decides ``correct``.

Every answer the window produced is judged against the plain
reconstruction (``lopc.reconstruct``) of the field it was asked about:

    cells_differing       cells whose bits differ from the reconstruction
                          (a container that does not read counts all of
                          its cells); limit 0: the method is exact
    order_violations      Freudenthal neighbour pairs whose strict
                          Simulation-of-Simplicity order differs from the
                          original field's; limit 0, the configuration's
                          guarantee of full local order
    max_error_over_bound  max |decoded - original| / eps_abs; limit 1,
                          the configuration's error bound
    unanswered            requests that raised or returned nothing;
                          limit 0

An answer byte-equal to one already judged equal to the reconstruction
of the same field is equal to it too, and is not decoded again.

The control (``control_values``) is the reconstruction computed one
precision below the field's: float32 for a float64 field, a field held
in bfloat16 for a float32 one.
"""
from __future__ import annotations

import numpy as np
import torch

from . import container, lopc

LIMITS = {"cells_differing": 0, "order_violations": 0,
          "max_error_over_bound": 1.0, "unanswered": 0}


def order_violations(x: torch.Tensor, y: torch.Tensor) -> int:
    """Pairs (p, p + off), off a positive Freudenthal offset, whose SoS
    order differs between ``x`` and ``y``.  With a positive offset the
    neighbour has the greater index, so it is the greater of the pair iff
    its value is >= p's."""
    x3 = lopc.flush(x.reshape((1,) * (3 - x.dim()) + tuple(x.shape)))
    y3 = lopc.flush(y.reshape(x3.shape))
    n = 0
    for off in lopc.offsets()[:7]:
        dst, src = lopc.slices(off, x3.shape)
        n += int(((x3[src] >= x3[dst]) != (y3[src] >= y3[dst])).sum())
    return n


def max_error(x: torch.Tensor, y: torch.Tensor, eps_abs: float) -> float:
    return float((y.double() - x.double()).abs().max()) / eps_abs


def differing(y: torch.Tensor, ref: torch.Tensor) -> int:
    if y.shape != ref.shape or y.dtype != ref.dtype:
        return ref.numel()
    idt = torch.int32 if ref.dtype == torch.float32 else torch.int64
    return int((y.view(idt) != ref.view(idt)).sum())


def expected(x: torch.Tensor, config: dict):
    """(values, eps_abs, relaxation sweeps): what every decode of ``x``
    must give."""
    if (config.get("mode", "noa") != "noa" or config.get("adaptive_eb", "off") != "off"
            or not config.get("preserve_order", True)):
        raise NotImplementedError(
            "the reference reads the uniform NOA bound with the order kept only")
    return lopc.reconstruct(x, config["eb"])


def control_values(x: torch.Tensor, config: dict) -> torch.Tensor:
    """The reconstruction one precision below the configuration's."""
    if x.dtype == torch.float64:
        low = x.float()
    else:
        low = x.bfloat16().float()
    return expected(low, config)[0].to(x.dtype)


def _read_container(blob, config: dict, x: torch.Tensor):
    c = container.read(blob, x.device)
    if (c["shape"] != tuple(x.shape) or c["dtype"] != x.dtype
            or c["mode"] != config.get("mode", "noa") or c["eb"] != config["eb"]
            or bool(c["flags"] & 1) != bool(config.get("preserve_order", True))):
        raise ValueError("header does not describe the request")
    return container.values(c)


def judge(config: dict, op: str, pool, answers, device) -> dict:
    """Numbers of the comparison over ``answers`` [(pool index, answer or
    None)], answers being containers (op compress) or decoded arrays."""
    out = {"cells_differing": 0, "order_violations": 0,
           "max_error_over_bound": 0.0, "unanswered": 0, "judged": 0,
           "sweeps": {}}
    refs, equal = {}, {}
    for k, ans in answers:
        if ans is None:
            out["unanswered"] += 1
            continue
        out["judged"] += 1
        if any(_same(ans, e) for e in equal.get(k, [])):
            continue
        if k not in refs:
            x = torch.from_numpy(pool[k]).to(device)
            ref, eps_abs, out["sweeps"][k] = expected(x, config)
            refs[k] = (x, ref, eps_abs)
        x, ref, eps_abs = refs[k]
        if op == "compress":
            try:
                y = _read_container(ans, config, x)
            except ValueError:
                out["cells_differing"] += ref.numel()
                continue
        else:
            y = torch.from_numpy(np.ascontiguousarray(ans)).to(device)
        d = differing(y, ref)
        out["cells_differing"] += d
        if y.shape == ref.shape:
            out["order_violations"] += order_violations(x, y)
            out["max_error_over_bound"] = max(out["max_error_over_bound"],
                                              max_error(x, y, eps_abs))
        if d == 0:
            equal.setdefault(k, []).append(ans)
    return out


def _same(a, b) -> bool:
    if isinstance(a, (bytes, bytearray)):
        return a == b
    return (a.shape == b.shape and a.dtype == b.dtype
            and np.array_equal(a.view(np.uint8), b.view(np.uint8)))


def passed(numbers: dict) -> bool:
    return all(numbers[k] <= lim for k, lim in LIMITS.items())
