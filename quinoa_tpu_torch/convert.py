"""Carry geometry and state between quinoa_tpu and the port as plain
numpy dicts.

The JAX package's DGGeom and DGState (DG), and its CGGeom, EdgeTables and
CGState (ALECG), are handed over as ``{field name: numpy array}`` dicts
(plus ``ndof``, ``nelem_real`` and ``tables`` for a DG geometry, ``nnode``
for a CG one), so this module never imports jax:

    arrays = {f.name: np.asarray(getattr(g, f.name))
              for f in dataclasses.fields(g)}          # g: a JAX DGGeom
    arrays["tables"] = dict(g.tables)
    geom = geom_from_arrays(arrays, device="cuda", dtype=torch.float32)

A sharded (SPMD) state crosses as the JAX package's stacked arrays,
``{field: (S, ...) numpy}`` with shard s's block in row s; the port holds
one tensor per shard in each field (``sharded_state_from_stacked`` and
``sharded_state_to_stacked``).

A walker's state crosses as the JAX walker's particle array, the data of
its key (``jax.random.key_data``) and its step counter
(``walker_state_from_arrays``).

Geometries of any order (ndof 1, 4 or 10) and states of any component
count (Euler's 5, multimat's 3*nmat + 3) cross as they are: the arrays
carry their shapes, and ``ndof`` and the tables come with the geometry.
Floating fields take ``dtype``; index fields stay int32.  Every
``*_from_arrays`` builds on the card unless ``device`` says otherwise.  Fields the port
does not carry (the CG window ``plan``) are ignored.
"""

from __future__ import annotations

import numpy as np
import torch

from .device import DEFAULT_DEVICE, resolve_device
from .pde import cg
from .pde.dg import DGGeom, GEOM_INT_FIELDS, GEOM_TENSOR_FIELDS

STATE_FIELDS = ("u", "ndofel", "t", "it", "dt")
CG_STATE_FIELDS = ("u", "t", "it", "dt")
EDGE_FIELDS = ("edges", "A", "ensup", "xyz")
_INT_FIELDS = (set(GEOM_INT_FIELDS) | set(cg.GEOM_INT_FIELDS)
               | {"ndofel", "it", "edges", "ensup"})


def _tensor(a, name, device, dtype):
    """A copy of ``a`` on ``device``: index fields int32, others ``dtype``
    (cast on the host, so a float32 value is the float64 one rounded)."""
    if name in _INT_FIELDS:
        return torch.from_numpy(np.array(a, dtype=np.int32)).to(device)
    return torch.from_numpy(np.array(a, dtype=np.float64)).to(dtype).to(
        device)


def _tensors(arrays, names, device, dtype, what):
    missing = [k for k in names if k not in arrays]
    if missing:
        raise KeyError(f"{what} dict lacks {missing}")
    device = resolve_device(device)
    return {k: _tensor(arrays[k], k, device, dtype).contiguous()
            for k in names}


def geom_from_arrays(arrays: dict, device=DEFAULT_DEVICE,
                     dtype: torch.dtype = torch.float64) -> DGGeom:
    """A DGGeom on ``device`` from a dict of numpy arrays."""
    missing = [k for k in ("ndof", "tables") if k not in arrays]
    if missing:
        raise KeyError(f"geometry dict lacks {missing}")
    fields = _tensors(arrays, GEOM_TENSOR_FIELDS, device, dtype, "geometry")
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


def state_from_arrays(arrays: dict, device=DEFAULT_DEVICE,
                      dtype: torch.dtype = torch.float64):
    """A DGState on ``device`` from a dict of numpy arrays."""
    from .inciter.dg import DGState

    return DGState(**_tensors(arrays, STATE_FIELDS, device, dtype, "state"))


def state_to_arrays(state) -> dict:
    """The inverse of state_from_arrays."""
    return {k: getattr(state, k).cpu().numpy() for k in STATE_FIELDS}


def cg_geom_from_arrays(arrays: dict, device=DEFAULT_DEVICE,
                        dtype: torch.dtype = torch.float64) -> cg.CGGeom:
    """A CGGeom on ``device`` from a dict of numpy arrays."""
    if "nnode" not in arrays:
        raise KeyError("geometry dict lacks ['nnode']")
    return cg.CGGeom(**_tensors(arrays, cg.GEOM_TENSOR_FIELDS, device, dtype,
                                "geometry"), nnode=int(arrays["nnode"]))


def cg_geom_to_arrays(geom: cg.CGGeom) -> dict:
    """The inverse of cg_geom_from_arrays."""
    out = {k: getattr(geom, k).cpu().numpy() for k in cg.GEOM_TENSOR_FIELDS}
    out["nnode"] = geom.nnode
    return out


def edge_tables_from_arrays(arrays: dict, device=DEFAULT_DEVICE,
                            dtype: torch.dtype = torch.float64):
    """ALECG EdgeTables on ``device`` from a dict of numpy arrays."""
    from .inciter.alecg import EdgeTables

    return EdgeTables(**_tensors(arrays, EDGE_FIELDS, device, dtype,
                                 "edge table"))


def edge_tables_to_arrays(edget) -> dict:
    """The inverse of edge_tables_from_arrays."""
    return {k: getattr(edget, k).cpu().numpy() for k in EDGE_FIELDS}


def cg_state_from_arrays(arrays: dict, device=DEFAULT_DEVICE,
                         dtype: torch.dtype = torch.float64):
    """A CGState on ``device`` from a dict of numpy arrays."""
    from .inciter.diagcg import CGState

    return CGState(**_tensors(arrays, CG_STATE_FIELDS, device, dtype,
                              "state"))


def cg_state_to_arrays(state) -> dict:
    """The inverse of cg_state_from_arrays."""
    return {k: getattr(state, k).cpu().numpy() for k in CG_STATE_FIELDS}


def shard_of(state, s: int):
    """Shard s's state (the same class, one tensor per field) of a
    sharded state."""
    return type(state)(**{f: v[s] for f, v in vars(state).items()})


def sharded_state_from_arrays(per, state_cls, devices,
                              dtype: torch.dtype = torch.float64):
    """A sharded state of ``state_cls`` (DGState or CGState) from one
    {field: numpy} dict per shard, shard s on devices[s]."""
    build = (state_from_arrays if state_cls.__name__ == "DGState"
             else cg_state_from_arrays)
    shards = [build(a, device=d, dtype=dtype) for a, d in zip(per, devices)]
    return state_cls(**{f: [getattr(st, f) for st in shards]
                        for f in vars(shards[0])})


def sharded_state_from_stacked(arrays: dict, state_cls, devices,
                               dtype: torch.dtype = torch.float64):
    """A sharded state from the JAX package's stacked SPMD state arrays
    ({field: (S, ...)}), shard s on devices[s]."""
    S = len(devices)
    return sharded_state_from_arrays(
        [{k: np.asarray(v)[s] for k, v in arrays.items()} for s in range(S)],
        state_cls, devices, dtype)


def sharded_state_to_stacked(state) -> dict:
    """The inverse of sharded_state_from_stacked: {field: (S, ...)}."""
    return {f: np.stack([x.detach().cpu().numpy() for x in v])
            for f, v in vars(state).items()}


def walker_state_from_arrays(walker, P, key, it0: int) -> torch.Tensor:
    """Continue a run of the JAX package's walker in the port's
    ``walker`` (a quinoa_tpu_torch.walker.Walker of the same systems):
    P is the JAX walker's particle array (numpy, (npar, nprop)), key its
    key's data (the two uint32 words of jax.random.key_data) and it0 its
    step counter (its ``_it0``).  Sets the walker's key and counter and
    returns P as a tensor in the walker's dtype on its device; the next
    ``walker.run(n, P=...)`` draws what the JAX walker's would."""
    P = np.asarray(P, dtype=np.float64)
    if P.shape != (walker.npar, walker.nprop):
        raise ValueError(f"particle array {P.shape} does not fit the "
                         f"walker's ({walker.npar}, {walker.nprop})")
    k = np.asarray(key).reshape(-1)
    if k.shape != (2,):
        raise ValueError(f"key data of shape {np.asarray(key).shape}: "
                         "expected two 32-bit words")
    walker.key = (int(k[0]) & 0xFFFFFFFF, int(k[1]) & 0xFFFFFFFF)
    walker._it0 = int(it0)
    return torch.from_numpy(P).to(walker.dtype).to(walker.device)
