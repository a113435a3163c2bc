"""Node gather and node assembly of the CG schemes: K10 and K11.

Port of quinoa_tpu/ops/node_window.py.  The TPU versions run the slot ->
node incidence through window tables (NodePlan): each tile of element
slots reads or accumulates its nodes through one-hot MXU products against
a two-block VMEM window and sends the far slots through compact XLA
gathers and a second, target-sorted pass, because a TPU core cannot gather
or scatter in HBM.  None of that carries over (no NodePlan, no windows, no
near/far split, no one-hot contraction): the card reads device memory
directly.  Here:

- K10 node_gather (csrc/node_gather.cu), one thread per element: U (R, N)
  -> (4, R, E), each element's four corner values;
- K11 node_assemble (csrc/node_assemble.cu), one thread per node and row
  chunk: a (4, Ra, E) slab summed and a (4 or 1, Rm, E) slab maxed over
  each node's slots of nsup, in one pass.

The plain versions are the JAX package's XLA formulations
(ops/assembly.py), in the kernels' order; a CPU tensor takes them, a CUDA
tensor launches the kernel.
"""

from __future__ import annotations

from typing import Optional

import torch

from .. import kernels
from .assembly import assemble_add, assemble_add_max, assemble_max, gather_nodes


def node_gather_plain(U: torch.Tensor, inpoelT: torch.Tensor) -> torch.Tensor:
    """K10's plain version: (4, R, E) = U[:, inpoelT[a]] for each corner."""
    return gather_nodes(U, inpoelT)


def node_gather(U: torch.Tensor, inpoelT: torch.Tensor) -> torch.Tensor:
    """Nodal rows U (R, N) -> element-corner slabs (4, R, E)."""
    if U.device.type == "cpu":
        return node_gather_plain(U, inpoelT)
    return kernels.node_gather(U, inpoelT)


def node_assemble_plain(xa: Optional[torch.Tensor],
                        xm: Optional[torch.Tensor],
                        nsup: torch.Tensor) -> torch.Tensor:
    """K11's plain version: (Ra + Rm, N), the sum rows of xa (4, Ra, E)
    then the max rows of xm (Am, Rm, E), Am = 4 or 1 (one row shared by
    an element's four corners)."""
    if xm is not None:
        xm = xm.expand((4,) + tuple(xm.shape[1:]))
    if xm is None:
        return assemble_add(xa, nsup)
    if xa is None:
        return assemble_max(xm, nsup)
    return torch.cat(assemble_add_max(xa, xm, nsup))


def node_assemble(xa: Optional[torch.Tensor], xm: Optional[torch.Tensor],
                  nsup: torch.Tensor) -> torch.Tensor:
    """Sum rows of xa and max rows of xm over each node's slots, stacked
    (Ra + Rm, N); a pad slot reads 0 in a sum row and finfo.min in a max
    row, and a NaN propagates through the max."""
    ref = xa if xa is not None else xm
    if ref.device.type == "cpu":
        return node_assemble_plain(xa, xm, nsup)
    return kernels.node_assemble(xa, xm, nsup)
