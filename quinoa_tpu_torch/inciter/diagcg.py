"""The time-marching state of the node-centred (CG) schemes.

Port of quinoa_tpu/inciter/diagcg.py:30-42 (CGState).  The DiagCG + FCT
solver itself is not ported yet.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class CGState:
    """Time-marching state for node-centred schemes; u is (C, nnode)."""

    u: torch.Tensor
    t: torch.Tensor
    it: torch.Tensor
    dt: torch.Tensor
