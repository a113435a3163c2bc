"""Checkpoint / restart, single device.

The port's own copy of the single-device part of
quinoa_tpu/inciter/checkpoint.py (the reference's Charm++ double
checkpoint: CkStartCheckpoint every rsfreq steps and `+restart <dir>`,
src/Inciter/Transporter.cpp:951-976).  The state's fields and run
metadata go atomically into the next of two alternating slots
(`slot0`, `slot1`; `latest` names the newest), as `state.npz` and
`meta.json` with the JAX package's field names, so a checkpoint written
by either package restarts the other.  Restart loads the fields into a
freshly built solver's state class on the solver's device; the mesh and
geometry are rebuilt from the original inputs.
"""

from __future__ import annotations

import dataclasses
import json
import os
import tempfile
import zipfile
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..device import DEFAULT_DEVICE


def save_checkpoint(dirpath: str, state,
                    meta: Optional[Dict[str, Any]] = None) -> str:
    """Write state into the next of two alternating slots (atomic rename)."""
    os.makedirs(dirpath, exist_ok=True)
    seq = 0
    seqfile = os.path.join(dirpath, "latest")
    if os.path.exists(seqfile):
        with open(seqfile) as fh:
            seq = int(fh.read().strip()) + 1
    slot = os.path.join(dirpath, f"slot{seq % 2}")
    os.makedirs(slot, exist_ok=True)

    names = [f.name for f in dataclasses.fields(state)]
    arrays = {k: getattr(state, k).detach().cpu().numpy() for k in names}
    tmp = tempfile.NamedTemporaryFile(dir=slot, suffix=".npz", delete=False)
    np.savez(tmp, **arrays)
    tmp.close()
    os.replace(tmp.name, os.path.join(slot, "state.npz"))
    with open(os.path.join(slot, "meta.json"), "w") as fh:
        json.dump({"seq": seq, "fields": names, **(meta or {})}, fh)
    with open(seqfile + ".tmp", "w") as fh:
        fh.write(str(seq))
    os.replace(seqfile + ".tmp", seqfile)
    return slot


class CheckpointMismatch(ValueError):
    """A checkpoint whose fields do not fit the solver built from the
    input mesh: it was written after a remesh (amr dtref), and the slot
    holds the state's fields only, not the refined mesh."""


def load_checkpoint(dirpath: str, state_cls, device=DEFAULT_DEVICE,
                    dtype: Optional[torch.dtype] = None, like=None):
    """Load the newest complete snapshot; returns (state, meta).

    The state is a ``state_cls`` (DGState or CGState) on ``device``,
    built through convert.state_from_arrays / cg_state_from_arrays:
    floating fields take ``dtype`` (None: torch's default float), so a
    float64 checkpoint restarts a float32 run rounded, as the JAX package
    truncates under its default float; integer fields keep their stored
    values.  Given ``like`` (the freshly built solver's state), a
    snapshot whose fields' shapes differ from like's raises
    CheckpointMismatch before any tensor is made.
    """
    from .. import convert
    from .dg import DGState

    if dtype is None:
        dtype = torch.get_default_dtype()
    build = (convert.state_from_arrays if state_cls is DGState
             else convert.cg_state_from_arrays)
    seqfile = os.path.join(dirpath, "latest")
    if not os.path.exists(seqfile):
        raise FileNotFoundError(f"no checkpoint in {dirpath}")
    with open(seqfile) as fh:
        seq = int(fh.read().strip())
    for trial in (seq, seq - 1):
        if trial < 0:
            break
        slot = os.path.join(dirpath, f"slot{trial % 2}")
        try:
            with open(os.path.join(slot, "meta.json")) as fh:
                meta = json.load(fh)
            if meta["seq"] != trial:
                continue
            with np.load(os.path.join(slot, "state.npz")) as data:
                arrays = {k: data[k] for k in meta["fields"]}
        except (OSError, ValueError, KeyError, zipfile.BadZipFile):
            continue
        if like is not None:
            _check_fits(dirpath, arrays, like)
        try:
            return build(arrays, device=device, dtype=dtype), meta
        except (ValueError, KeyError):
            continue
    raise IOError(f"no readable checkpoint slot in {dirpath}")


def _check_fits(dirpath, arrays, like):
    for f in dataclasses.fields(like):
        if f.name not in arrays:
            continue
        want = tuple(getattr(like, f.name).shape)
        got = tuple(np.shape(arrays[f.name]))
        if got != want:
            raise CheckpointMismatch(
                f"checkpoint {dirpath} holds {f.name} of shape {got}, but "
                f"the solver built from the input mesh has {want}: the "
                "checkpoint was written after a remesh (amr dtref), and a "
                "restart from a refined mesh is not ported yet")
