"""Weights, optimizer state and caches across the two packages' layouts.

The reference keeps its parameters as a pytree: each pattern slot's
block weights stacked over the groups (``groups/slot{i}``), plus
``tail``, ``shared``, ``embed``, ``img_proj``, ``final_norm`` and
``lm_head``.  The port holds one module per layer (``layers.{L}``, ``L
= g * len(pattern) + i``); its parameter names are the reference's leaf
paths.  The AdamW state's moments (and the error-feedback buffer of
gradient compression) have the parameters' layout.  None of these
functions imports the reference: they take and give nested dicts and
lists of numpy arrays or tensors.
"""
from __future__ import annotations

import numpy as np
import torch

from .config import ModelConfig


def _flatten(tree, prefix: str, out: dict) -> None:
    if isinstance(tree, dict):
        for k, v in tree.items():
            _flatten(v, f"{prefix}{k}.", out)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            _flatten(v, f"{prefix}{i}.", out)
    else:
        out[prefix[:-1]] = np.asarray(tree)


def params_from_reference(tree: dict, cfg: ModelConfig) -> dict:
    """The reference's ``init_params`` tree (numpy or CPU tensor leaves)
    as the port's state dict (``Model.load_state_dict``)."""
    period = len(cfg.pattern)
    n_groups = cfg.n_layers // period
    flat: dict = {}
    for key, sub in tree.items():
        if key == "groups":
            for slot, stacked in sub.items():
                i = int(slot.removeprefix("slot"))
                leaves: dict = {}
                _flatten(stacked, "", leaves)
                for name, arr in leaves.items():
                    for g in range(n_groups):
                        flat[f"layers.{g * period + i}.{name}"] = arr[g]
        elif key == "tail":
            for j, block in enumerate(sub):
                _flatten(block, f"layers.{n_groups * period + j}.", flat)
        else:
            _flatten(sub, f"{key}.", flat)
    return {k: torch.from_numpy(np.array(v, copy=True)) for k, v in flat.items()}


def _nest(flat: dict) -> dict:
    out: dict = {}
    for name, v in flat.items():
        *path, leaf = name.split(".")
        d = out
        for p in path:
            d = d.setdefault(p, {})
        d[leaf] = v
    return out


def params_to_reference(state: dict, cfg: ModelConfig) -> dict:
    """The inverse of ``params_from_reference``: the port's state dict
    (``{name: tensor}``, e.g. ``Model.state_dict()``) as the reference's
    tree, each grouped leaf stacked over the groups on its device."""
    period = len(cfg.pattern)
    grouped = (cfg.n_layers // period) * period
    slots: dict = {f"slot{i}": {} for i in range(period)}
    tail: dict = {}
    other: dict = {}
    for name, t in state.items():
        parts = name.split(".")
        if parts[0] != "layers":
            other[name] = t
            continue
        layer, rest = int(parts[1]), ".".join(parts[2:])
        if layer < grouped:
            slots[f"slot{layer % period}"].setdefault(rest, []).append(
                (layer // period, t))
        else:
            tail.setdefault(layer - grouped, {})[rest] = t
    tree = _nest(other)
    tree["groups"] = {
        slot: _nest({k: torch.stack([t for _, t in sorted(v, key=lambda x: x[0])])
                     for k, v in leaves.items()})
        for slot, leaves in slots.items()}
    if tail:
        tree["tail"] = [_nest(tail[j]) for j in range(len(tail))]
    return tree


_PARAM_TREES = ("m", "v", "ef")


def opt_to_reference(opt: dict, cfg: ModelConfig) -> dict:
    """The port's AdamW state (``{"m", "v", "step"[, "ef"]}``, the trees
    keyed by parameter name) in the reference's layout."""
    return {k: (params_to_reference(v, cfg) if k in _PARAM_TREES else v)
            for k, v in opt.items()}


def opt_from_reference(tree: dict, cfg: ModelConfig, device="cpu") -> dict:
    """The reference's AdamW state tree (numpy or tensor leaves) as the
    port's, on ``device``: the moment trees keyed by parameter name,
    ``step`` a 0-d int32 tensor on the CPU."""
    out = {}
    for k, v in tree.items():
        if k in _PARAM_TREES:
            out[k] = {name: t.to(device)
                      for name, t in params_from_reference(v, cfg).items()}
        else:
            out[k] = torch.as_tensor(np.array(v)).to(torch.int32)
    return out


def _numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:  # numpy has no bfloat16: exact in f32
        t = t.float()
    return t.numpy()


def _leaves(cache: dict) -> dict:
    return {k: (_leaves(v) if isinstance(v, dict) else _numpy(v))
            for k, v in cache.items()}


def _stack(trees: list) -> dict:
    return {k: (_stack([t[k] for t in trees]) if isinstance(v, dict)
                else np.stack([t[k] for t in trees]))
            for k, v in trees[0].items()}


def cache_to_reference(caches: dict, cfg: ModelConfig) -> dict:
    """The port's caches laid out as the reference's ``init_cache`` tree:
    numpy leaves stacked over the groups, bf16 leaves as float32 (the
    values are exact), ``len`` an int."""
    period = len(cfg.pattern)
    n_groups = cfg.n_layers // period
    layers = [_leaves(c) for c in caches["layers"]]
    out = {"groups": {f"slot{i}": _stack([layers[g * period + i]
                                          for g in range(n_groups)])
                      for i in range(period)},
           "len": int(caches["len"])}
    if len(layers) > n_groups * period:
        out["tail"] = layers[n_groups * period:]
    if "shared" in caches:
        out["shared"] = _stack([_leaves(c) for c in caches["shared"]])
    return out
