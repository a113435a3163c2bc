"""Carry geometry and state between quinoa_tpu and the port as plain
numpy dicts.

The JAX package's DGGeom and DGState are handed over as
``{field name: numpy array}`` dicts (plus ``ndof``, ``nelem_real`` and
``tables`` for a geometry), so this module never imports jax:

    arrays = {f.name: np.asarray(getattr(g, f.name))
              for f in dataclasses.fields(g)}          # g: a JAX DGGeom
    arrays["tables"] = dict(g.tables)
    geom = geom_from_arrays(arrays, device="cuda", dtype=torch.float32)

Floating fields take ``dtype``; index fields stay int32.
"""

from __future__ import annotations

import numpy as np
import torch

from .pde.dg import DGGeom, GEOM_INT_FIELDS, GEOM_TENSOR_FIELDS

STATE_FIELDS = ("u", "ndofel", "t", "it", "dt")


def _tensor(a, name, device, dtype):
    """A copy of ``a`` on ``device``: index fields int32, others ``dtype``
    (cast on the host, so a float32 value is the float64 one rounded)."""
    if name in GEOM_INT_FIELDS or name in ("ndofel", "it"):
        return torch.from_numpy(np.array(a, dtype=np.int32)).to(device)
    return torch.from_numpy(np.array(a, dtype=np.float64)).to(dtype).to(
        device)


def geom_from_arrays(arrays: dict, device="cpu",
                     dtype: torch.dtype = torch.float64) -> DGGeom:
    """A DGGeom on ``device`` from a dict of numpy arrays."""
    missing = [k for k in GEOM_TENSOR_FIELDS + ("ndof", "tables")
               if k not in arrays]
    if missing:
        raise KeyError(f"geometry dict lacks {missing}")
    fields = {k: _tensor(arrays[k], k, device, dtype).contiguous()
              for k in GEOM_TENSOR_FIELDS}
    tables = {k: np.asarray(v, dtype=np.float64)
              for k, v in arrays["tables"].items()}
    return DGGeom(**fields, ndof=int(arrays["ndof"]),
                  nelem_real=int(arrays.get("nelem_real",
                                            fields["vol"].shape[0])),
                  tables=tables)


def geom_to_arrays(geom: DGGeom) -> dict:
    """The inverse of geom_from_arrays: numpy arrays on the host."""
    out = {k: getattr(geom, k).cpu().numpy() for k in GEOM_TENSOR_FIELDS}
    out.update(ndof=geom.ndof, nelem_real=geom.nelem_real,
               tables=dict(geom.tables))
    return out


def state_from_arrays(arrays: dict, device="cpu",
                      dtype: torch.dtype = torch.float64):
    """A DGState on ``device`` from a dict of numpy arrays."""
    from .inciter.dg import DGState

    return DGState(**{k: _tensor(arrays[k], k, device, dtype).contiguous()
                      for k in STATE_FIELDS})


def state_to_arrays(state) -> dict:
    """The inverse of state_from_arrays."""
    return {k: getattr(state, k).cpu().numpy() for k in STATE_FIELDS}
