"""Gather-based finite-element assembly (feature-major layout).

Port of quinoa_tpu/ops/assembly.py:26-75.  That module cannot be imported
here: quinoa_tpu/ops/__init__ imports jax.  Fields are component-major, U
is (C, N) and element slabs are (4, C, E); a node sums its incident slots
through the padded slot table nsup (D, N), slot level by slot level, so
the sum has one fixed order (no scatter, no atomics).
"""

from __future__ import annotations

import numpy as np
import torch


def build_nsup(inpoel: np.ndarray, nnode: int):
    """Slots-surrounding-node table for any incidence table.

    inpoel is (E, A): A slots per entity (4 for tets, 2 for edges).
    Returns (nsup (D, N) int32, D): nsup[d, p] is the flattened slot
    a*E + e (local slot a of entity e) that lands on node p, or A*E (a
    zero pad slot) where node p has fewer than D incident slots.  The
    native C++ pass of quinoa_tpu.native gives the same table when built.
    """
    from quinoa_tpu.native import build_nsup as _native

    nat = _native(np.asarray(inpoel), nnode)
    if nat is not None:
        return nat

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
