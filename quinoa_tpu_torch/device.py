"""The device the port's builders put their tensors on.

Every builder (build_dggeom, make_cggeom, build_edge_tables, make_alecg
and the convert.*_from_arrays) targets the card unless the caller asks for
another device; the CPU tests pass device="cpu".  Without a card the
default raises instead of carrying on on the CPU.
"""

from __future__ import annotations

import torch

#: the builders' default device
DEFAULT_DEVICE = "cuda"


def resolve_device(device=DEFAULT_DEVICE) -> torch.device:
    """``device`` as a torch.device; raises RuntimeError for a CUDA device
    when torch sees none."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"no CUDA device for device={str(device)!r}: the port builds on "
            "the card by default; pass device='cpu' to build on the CPU")
    return dev
