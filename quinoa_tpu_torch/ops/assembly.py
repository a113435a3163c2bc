"""Gather-based finite-element assembly (feature-major layout).

Port of quinoa_tpu/ops/assembly.py.  Fields are component-major, U is
(C, N) and element slabs are (4, C, E); a node sums (or takes the extreme
of) its incident slots through the padded slot table nsup (D, N), slot
level by slot level, so the result has one fixed order (no scatter, no
atomics).  These are the JAX package's XLA formulations; the kernels K10
and K11 (ops/node_window.py) compute the same values on the card.
"""

from __future__ import annotations

import numpy as np
import torch


def build_nsup(inpoel: np.ndarray, nnode: int):
    """Slots-surrounding-node table for any incidence table.

    inpoel is (E, A): A slots per entity (4 for tets, 2 for edges).
    Returns (nsup (D, N) int32, D): nsup[d, p] is the flattened slot
    a*E + e (local slot a of entity e) that lands on node p, or A*E (a
    pad slot) where node p has fewer than D incident slots; a node's
    slots are in increasing slot order, as the JAX package's native pass
    lists them.
    """
    E, A = inpoel.shape
    flat = inpoel.T.ravel()  # slot id s = a*E + e holds node inpoel[e, a]
    order = np.argsort(flat, kind="stable")
    counts = np.bincount(flat, minlength=nnode)
    D = int(counts.max()) if len(counts) else 0
    nsup = np.full((D, nnode), A * E, dtype=np.int32)
    pos = np.zeros(nnode + 1, dtype=np.int64)
    np.cumsum(counts, out=pos[1:])
    # column-fill: for node p, its slots are order[pos[p]:pos[p+1]]
    idx_in_node = np.arange(len(flat)) - pos[flat[order]]
    nsup[idx_in_node, flat[order]] = order.astype(np.int32)
    return nsup, D


def gather_nodes(U: torch.Tensor, inpoelT: torch.Tensor) -> torch.Tensor:
    """Nodal fields U (C, N) -> element-node slabs (4, C, E)."""
    return torch.stack([U[:, inpoelT[a].long()] for a in range(4)])


def assemble_add(contrib: torch.Tensor, nsup: torch.Tensor) -> torch.Tensor:
    """Sum entity-slot contributions (A, C, E) into nodes (C, N): level 0
    first, then levels 1, 2, ... added in order.  Pad entities must carry
    zero contributions."""
    A, C, E = contrib.shape
    flat = contrib.permute(1, 0, 2).reshape(C, A * E)
    flat = torch.cat([flat, flat.new_zeros((C, 1))], dim=1)
    out = flat[:, nsup[0].long()]
    for d in range(1, nsup.shape[0]):
        out = out + flat[:, nsup[d].long()]
    return out


def _assemble_extreme(contrib, nsup, op, fill):
    A, C, E = contrib.shape
    flat = contrib.permute(1, 0, 2).reshape(C, A * E)
    flat = torch.cat([flat, flat.new_full((C, 1), fill)], dim=1)
    out = flat[:, nsup[0].long()]
    for d in range(1, nsup.shape[0]):
        out = op(out, flat[:, nsup[d].long()])
    return out


def assemble_max(contrib: torch.Tensor, nsup: torch.Tensor) -> torch.Tensor:
    """Max of (A, C, E) slot contributions over each node's slots, (C, N);
    a pad slot reads finfo.min, and a NaN propagates (torch.maximum)."""
    return _assemble_extreme(contrib, nsup, torch.maximum,
                             torch.finfo(contrib.dtype).min)


def assemble_min(contrib: torch.Tensor, nsup: torch.Tensor) -> torch.Tensor:
    """Min over each node's slots, (C, N); a pad slot reads finfo.max."""
    return _assemble_extreme(contrib, nsup, torch.minimum,
                             torch.finfo(contrib.dtype).max)


def assemble_add_max(contribA: torch.Tensor, contribM: torch.Tensor,
                     nsup: torch.Tensor):
    """The sum-assembly of contribA (4, Ca, E) and the max-assembly of
    contribM (4, Cm, E) through one shared gather per slot level:
    ((Ca, N), (Cm, N)), each in the order of assemble_add/assemble_max."""
    A, Ca, E = contribA.shape
    Cm = contribM.shape[1]
    flat = torch.cat([contribA, contribM], dim=1)
    flat = flat.permute(1, 0, 2).reshape(Ca + Cm, A * E)
    pad = torch.cat([contribA.new_zeros((Ca, 1)),
                     contribM.new_full((Cm, 1),
                                       torch.finfo(contribM.dtype).min)])
    flat = torch.cat([flat, pad], dim=1)
    g = flat[:, nsup[0].long()]
    outA, outM = g[:Ca], g[Ca:]
    for d in range(1, nsup.shape[0]):
        g = flat[:, nsup[d].long()]
        outA = outA + g[:Ca]
        outM = torch.maximum(outM, g[Ca:])
    return outA, outM
