"""Hydro-timescale / production DNS data tables.

The port's own copy of quinoa_tpu/diffeq/hydro.py, with its own copy of
the data (hydro_tables.npz, the same arrays): inverse hydrodynamics
time scales (eps/k) and production-to-dissipation ratios (P/eps) from
Rayleigh-Taylor DNS runs (the reference's src/DiffEq/HydroTimeScales.hpp
invhts_eq_*, HydroProductions.hpp prod_*), sampled as tk::sample does
through base.table.Table.
"""

from __future__ import annotations

import functools
import os

import numpy as np

from ..base.table import Table

_NPZ = os.path.join(os.path.dirname(__file__), "hydro_tables.npz")


@functools.lru_cache(maxsize=None)
def _load():
    with np.load(_NPZ) as data:
        return dict(data)


def hydro_table(name: str) -> Table:
    """Table by deck keyword: 'eq_A05S' (timescales, stored invhts_eq_*)
    or 'prod_A05S' (productions)."""
    data = _load()
    key = name if name in data else f"invhts_{name}"
    if key not in data:
        raise KeyError(
            f"unknown hydro table {name!r}; have "
            f"{sorted(k.replace('invhts_', '') for k in data)}"
        )
    arr = data[key]
    return Table(arr[:, 0], arr[:, 1])
