"""walker -- time integration of SDE ensembles with online statistics.

The port's own copy of quinoa_tpu/walker/driver.py (the reference's
Distributor/Integrator/Collector, src/Walker/): the particle ensemble is
one (npar, nprop) tensor on one device, each step advances every system
in turn, and the moments are means over the ensemble.  With nshard > 1
(walker --npes) every ensemble mean, inside a step and in the moments,
adds the sums of nshard equal row blocks in block order
(statistics.block_mean), as the JAX walker's reduction over its sharded
'par' axis does; the draws are the whole ensemble's.  The keys are the
JAX package's: ``initialize`` folds 10_000 + i into the seed's key for
system i's init policy, ``run`` folds the global step into it and each
step folds the system's index into that, so the port draws the JAX
walker's numbers from the same seed.  The step is eager torch.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import torch

from ..device import DEFAULT_DEVICE, resolve_device
from ..rng import threefry
from ..statistics.pdf import estimate_pdf
from ..statistics.stats import Term, estimate_moments, moments_to_host


class Walker:
    """Drive a set of coupled SDE systems over a particle ensemble.

    systems : list of quinoa_tpu_torch.diffeq systems; offsets must
              already be laid out (use Walker.layout to assign them
              contiguously).
    npar    : ensemble size
    dt      : time step (the reference walker uses constant dt)
    seed    : RNG seed; per-step, per-system keys are folded from it
    ordinary/central : moment requests (statistics.Term) estimated at
              `stat_every` steps.
    dtype   : the particles' float type (None: torch's default)
    device  : where the particles live, the card unless the caller asks
              for another
    nshard  : the row blocks the ensemble means fold over (walker --npes;
              npar a multiple of it)
    """

    def __init__(
        self,
        systems: Sequence,
        npar: int,
        dt: float,
        t0: float = 0.0,
        seed: int = 0,
        ordinary: Sequence[Term] = (),
        central: Sequence[Term] = (),
        dtype=None,
        device=DEFAULT_DEVICE,
        nshard: int = 1,
    ):
        self.systems = list(systems)
        self.npar = npar
        self.dt = dt
        self.t0 = t0
        self.dtype = dtype or torch.get_default_dtype()
        self.device = resolve_device(device)
        self.key = threefry.key(seed)
        self.ordinary = list(ordinary)
        self.central = list(central)

        self.offsets: Dict[str, int] = {}
        for s in self.systems:
            self.offsets[s.depvar] = s.offset
        self.nprop = max(s.offset + s.nprop for s in self.systems)

        self._it0 = 0  # global step counter: successive run() calls draw
        # fresh per-step keys (never reuse a (seed, step) pair)
        if nshard < 1 or npar % nshard:
            raise ValueError(f"npar {npar} is not a multiple of the "
                             f"{nshard} shards")
        self.nshard = int(nshard)

    @staticmethod
    def layout(systems: Sequence) -> List:
        """Assign contiguous offsets to systems in order."""
        off = 0
        for s in systems:
            s.offset = off
            off += s.nprop
        return list(systems)

    # -- lifecycle ------------------------------------------------------------

    def initialize(self):
        """Apply each system's init policy (InitPolicy.hpp analog)."""
        P = torch.zeros((self.npar, self.nprop), dtype=self.dtype,
                        device=self.device)
        for i, s in enumerate(self.systems):
            k = threefry.fold_in(self.key, 10_000 + i)
            if s.init is not None:
                y0 = s.init(k, self.npar, dtype=self.dtype,
                            device=self.device)
                P[:, s.offset:s.offset + y0.shape[1]] = y0.to(self.dtype)
            if hasattr(s, "initialize_derived"):
                P = s.initialize_derived(P)
        return P

    def step(self, P, it: int, t: float):
        """One step of every system: the step's key is fold_in(key, it),
        system i's fold_in(step key, i)."""
        key = threefry.fold_in(self.key, it)
        for i, s in enumerate(self.systems):
            P = s.advance(threefry.fold_in(key, i), P, self.dt, t,
                          nshard=self.nshard)
        return P

    def moments(self, P):
        """The ordinary and central moments of the ensemble, {term: 0-d
        tensor}."""
        return estimate_moments(P, self.offsets, self.ordinary, self.central,
                                self.nshard)

    def run(self, nsteps: int, stat_every: int = 0, P=None):
        """Integrate; returns (P, history) where history is a list of
        (t, {term: value}) at `stat_every` intervals."""
        if P is None:
            P = self.initialize()
        t = self.t0 + self._it0 * self.dt
        history = []
        for it in range(self._it0, self._it0 + nsteps):
            P = self.step(P, it, t)
            t += self.dt
            if stat_every and (it + 1) % stat_every == 0:
                history.append((t, moments_to_host(self.moments(P))))
        self._it0 += nsteps
        return P, history

    def pdf(self, P, term, binsize, extents=None, central=None):
        return estimate_pdf(P, self.offsets, term, binsize, extents,
                            central=central)
