"""Parallel layer: mesh partitioning, shards, ghost and halo exchanges, and
the sharded solvers, driven by one controller over a list of devices.

The port's counterpart of quinoa_tpu/parallel (itself the counterpart of
the reference's Charm++ orchestration: Partitioner, Sorter, the comsol/
comrhs/comaec point-to-point exchanges of DG, DiagCG and ALECG, and the
Zoltan2 partitioners).  The JAX package runs one SPMD program over a 1-D
device mesh through shard_map, with psum/pmin/pmax/ppermute over its
"shard" axis.  The port keeps that structure in one process: a
ShardGroup holds S shards and the device of each, every shard is a full
local problem (its own geometry and state tensors, padded to the JAX
package's per-shard shapes, so a shard's block is the JAX stacked
array's row s), and the collectives are plain functions on the list of
shards.  Sums, minima and maxima fold the shards in the order 0..S-1 and
slabs move with ``.to(device)``, so a run repeats bit for bit wherever
its shards live.  Shard s lives on devices[s % len(devices)]: on a
machine with one card every shard is resident on it.  The devices
default to the card, as the port's other builders do; the CPU tests
pass ["cpu"].
"""

from __future__ import annotations

from typing import List, Sequence

import torch

from ..device import DEFAULT_DEVICE, resolve_device


class ShardGroup:
    """S shards and the device of each (shard s on devices[s % n]); the
    devices default to the card and raise without one."""

    def __init__(self, nshard: int, devices: Sequence = (DEFAULT_DEVICE,)):
        if nshard < 1:
            raise ValueError("nshard must be >= 1")
        devs = [resolve_device(d) for d in devices]
        if not devs:
            raise ValueError("a shard group needs at least one device")
        self.nshard = int(nshard)
        self.devices: List[torch.device] = [devs[s % len(devs)]
                                            for s in range(self.nshard)]

    def placement(self) -> str:
        """One line naming each device and the shards it holds."""
        by = {}
        for s, d in enumerate(self.devices):
            by.setdefault(str(d), []).append(s)
        return ", ".join(f"{d}: shards {v[0]}-{v[-1]}" if len(v) > 1
                         else f"{d}: shard {v[0]}" for d, v in by.items())

    def fold(self, xs, op):
        """op folded over xs in shard order on shard 0's device; each
        shard gets the result on its own device."""
        acc = xs[0]
        for x in xs[1:]:
            acc = op(acc, x.to(acc.device))
        return [acc.to(d) for d in self.devices]

    def psum(self, xs):
        return self.fold(xs, torch.add)

    def pmin(self, xs):
        return self.fold(xs, torch.minimum)

    def pmax(self, xs):
        return self.fold(xs, torch.maximum)


from .partition import (morton_partition, partition_elements,  # noqa: E402
                        rcb_partition)
from .shard import ShardedCG, build_cg_shards  # noqa: E402
from .spmd import SPMDDiagCGSolver  # noqa: E402
from .dg_shard import ShardedDG, build_dg_shards  # noqa: E402
from .dg_spmd import SPMDDGSolver, SPMDMultiMatSolver  # noqa: E402
from .alecg_spmd import (SPMDALECGSolver, ShardedALECG,  # noqa: E402
                         build_alecg_shards)

__all__ = [
    "ShardGroup",
    "morton_partition",
    "rcb_partition",
    "partition_elements",
    "ShardedCG",
    "build_cg_shards",
    "SPMDDiagCGSolver",
    "ShardedDG",
    "build_dg_shards",
    "SPMDDGSolver",
    "SPMDMultiMatSolver",
    "ShardedALECG",
    "build_alecg_shards",
    "SPMDALECGSolver",
]
