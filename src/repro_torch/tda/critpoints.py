"""Critical-point census on PL scalar fields (port of
``repro.tda.critpoints``), as torch ops on the field's device.

Classification on the Freudenthal link of each vertex, under Simulation
of Simplicity (all comparisons on (value, linear index)):

  lower link empty            -> local minimum
  upper link empty            -> local maximum
  1 lower CC and 1 upper CC   -> regular
  otherwise                   -> saddle

The compared type is the exact signature (n_lower_cc, n_upper_cc),
which tells 1- from 2-saddles and monkey saddles.  Components of the
lower (upper) link are counted by min-label propagation over the static
link graph: K <= 14 vertices of diameter <= 4, so K Jacobi sweeps
converge.  Each label sweep takes a vertex's minimum over its link
neighbours only (``topology.link_adjacency``), which gives the
reference's labels with a fraction of its work.

Inputs are tensors (computed on their own device) or numpy arrays
(uploaded to ``device``, the CUDA device unless the caller passes
``device="cpu"``).
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import topology

CLASS_REGULAR = 0
CLASS_MIN = 1
CLASS_MAX = 2
CLASS_SADDLE = 3

_NO_LABEL = 127


def _tensor(values, device) -> torch.Tensor:
    """A tensor as it is; anything numpy reads, uploaded to ``device``."""
    if isinstance(values, torch.Tensor):
        return values
    from ..engine import resolve_device

    return torch.from_numpy(np.ascontiguousarray(values)).to(
        resolve_device(device))


def _neighbor_relation(values: torch.Tensor):
    """(lower, upper, valid) lists of K bool masks of the grid's shape,
    under SoS."""
    ndim = values.dim()
    values = topology.flush_subnormals(values)
    ones = torch.ones(values.shape, dtype=torch.bool, device=values.device)
    lowers, uppers, valids = [], [], []
    for k, off in enumerate(topology.offsets(ndim)):
        nv = topology.shift(values, off, float("inf"))
        # a shifted-in +inf cell is outside the grid: track it apart
        valid = topology.shift(ones, off, False)
        lower = topology.sos_less(nv, values, k, ndim) & valid
        lowers.append(lower)
        uppers.append(valid & ~lower)
        valids.append(valid)
    return lowers, uppers, valids


def _count_components(member: list, adj: np.ndarray) -> torch.Tensor:
    """#components of the link subgraph induced by ``member`` (K masks)
    -> int8 per grid point."""
    k = len(member)
    labels = [torch.where(m, torch.tensor(i, dtype=torch.int8, device=m.device),
                          torch.tensor(_NO_LABEL, dtype=torch.int8,
                                       device=m.device))
              for i, m in enumerate(member)]
    nbrs = [np.flatnonzero(adj[i]) for i in range(k)]
    for _ in range(k):
        new = []
        for i in range(k):
            m = labels[i]
            for j in nbrs[i]:
                m = torch.minimum(m, torch.where(member[j], labels[j], _NO_LABEL))
            new.append(torch.where(member[i], m, _NO_LABEL))
        labels = new
    count = torch.zeros(member[0].shape, dtype=torch.int8,
                        device=member[0].device)
    for i in range(k):
        count += (member[i] & (labels[i] == i)).to(torch.int8)
    return count


def critical_signature(values, device="cuda"):
    """(n_lower_cc, n_upper_cc) int8 per vertex: the exact type signature."""
    values = _tensor(values, device)
    adj = topology.link_adjacency(values.dim())
    lower, upper, _ = _neighbor_relation(values)
    return _count_components(lower, adj), _count_components(upper, adj)


def classify_critical_points(values, device="cuda") -> torch.Tensor:
    """int8 class per vertex: 0 regular / 1 min / 2 max / 3 saddle."""
    lo, up = critical_signature(values, device)
    cls = torch.where((lo == 1) & (up == 1), CLASS_REGULAR, CLASS_SADDLE)
    cls = torch.where(lo == 0, CLASS_MIN, cls)
    cls = torch.where(up == 0, CLASS_MAX, cls)
    return cls.to(torch.int8)


def critical_point_errors(original, reconstructed, device="cuda"):
    """(false_positives, false_negatives, false_types), the paper's Table
    III metrics.

    FP: critical in the reconstruction, regular in the original.
    FN: critical in the original, regular in the reconstruction.
    FT: critical in both with a different exact signature.
    """
    lo_o, up_o = critical_signature(original, device)
    lo_r, up_r = critical_signature(reconstructed, device)
    crit_o = (lo_o != 1) | (up_o != 1)
    crit_r = (lo_r != 1) | (up_r != 1)
    fp = int((crit_r & ~crit_o).sum())
    fn = int((crit_o & ~crit_r).sum())
    ft = int((crit_o & crit_r & ((lo_o != lo_r) | (up_o != up_r))).sum())
    return fp, fn, ft


def local_order_violations(original, reconstructed, device="cuda") -> int:
    """#neighbour pairs whose SoS order differs (0 for LOPC, by theorem);
    each undirected pair counts once (the positive offsets)."""
    lower_o, _, valid = _neighbor_relation(_tensor(original, device))
    lower_r, _, _ = _neighbor_relation(_tensor(reconstructed, device))
    half = len(lower_o) // 2
    return sum(int(((lower_o[k] != lower_r[k]) & valid[k]).sum())
               for k in range(half))
