"""Checkpoint / restart, single device and sharded.

The port's own copy of quinoa_tpu/inciter/checkpoint.py (the reference's
Charm++ double checkpoint: CkStartCheckpoint every rsfreq steps and
`+restart <dir>`, src/Inciter/Transporter.cpp:951-976).  The state's
fields and run metadata go atomically into the next of two alternating
slots (`slot0`, `slot1`; `latest` names the newest), as `state.npz` and
`meta.json` with the JAX package's field names, so a checkpoint written
by either package restarts the other.  A sharded state writes one
`shard<k>.npz` per shard with the JAX package's (1, ...) blocks of its
stacked arrays (the per-chare checkpoint files; the padded per-shard
shapes are the JAX package's), and `state.npz` holds the fields that are
not sharded.  Restart loads the fields into a freshly built solver's
state class on the solver's devices; the mesh and geometry are rebuilt
from the original inputs.
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


def _next_slot(dirpath: str):
    os.makedirs(dirpath, exist_ok=True)
    seq = 0
    seqfile = os.path.join(dirpath, "latest")
    if os.path.exists(seqfile):
        with open(seqfile) as fh:
            seq = int(fh.read().strip()) + 1
    slot = os.path.join(dirpath, f"slot{seq % 2}")
    os.makedirs(slot, exist_ok=True)
    return seq, seqfile, slot


def _savez(slot: str, name: str, arrays) -> None:
    tmp = tempfile.NamedTemporaryFile(dir=slot, suffix=".npz", delete=False)
    np.savez(tmp, **arrays)
    tmp.close()
    os.replace(tmp.name, os.path.join(slot, name))


def _commit(slot, seqfile, seq, manifest):
    with open(os.path.join(slot, "meta.json"), "w") as fh:
        json.dump(manifest, fh)
    with open(seqfile + ".tmp", "w") as fh:
        fh.write(str(seq))
    os.replace(seqfile + ".tmp", seqfile)


def save_checkpoint(dirpath: str, state,
                    meta: Optional[Dict[str, Any]] = None) -> str:
    """Write state into the next of two alternating slots (atomic rename)."""
    seq, seqfile, slot = _next_slot(dirpath)
    names = [f.name for f in dataclasses.fields(state)]
    _savez(slot, "state.npz",
           {k: getattr(state, k).detach().cpu().numpy() for k in names})
    _commit(slot, seqfile, seq, {"seq": seq, "fields": names, **(meta or {})})
    return slot


def save_checkpoint_sharded(dirpath: str, state,
                            meta: Optional[Dict[str, Any]] = None) -> str:
    """Per-shard double checkpoint of a sharded state (one tensor per shard
    in each field), in the JAX package's layout: with S > 1 shards,
    shard<k>.npz holds shard k's (1, ...) block of every field and
    state.npz nothing; with one shard, state.npz holds the (1, ...)
    arrays (a one-device JAX array has a single addressable shard)."""
    seq, seqfile, slot = _next_slot(dirpath)
    names = [f.name for f in dataclasses.fields(state)]
    S = len(getattr(state, names[0]))

    def block(x):
        return x.detach().cpu().numpy()[None]

    scalars, sharded = {}, {}
    if S > 1:
        for k in range(S):
            _savez(slot, f"shard{k}.npz",
                   {n: block(getattr(state, n)[k]) for n in names})
        sharded = set(names)
    else:
        scalars = {n: block(getattr(state, n)[0]) for n in names}
    _savez(slot, "state.npz", scalars)
    _commit(slot, seqfile, seq, {
        "seq": seq, "fields": names, "scalar_fields": sorted(scalars),
        "sharded_fields": sorted(sharded), "nshard": S if S > 1 else 0,
        **(meta or {})})
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
                "checkpoint was written after a remesh (amr dtref) or for "
                "another partition (--npes, -u), and a restart from "
                "another mesh or partition is not ported")


def load_checkpoint_sharded(dirpath: str, state_cls, devices,
                            dtype: Optional[torch.dtype] = None, like=None):
    """Load the newest complete per-shard snapshot onto a sharded state
    (shard s's tensors on devices[s]); returns (state, meta).

    A checkpoint whose shard count the number of shards does not divide
    raises RuntimeError, as the JAX package's does; one whose per-shard
    blocks do not fit ``like`` (another count of shards or another
    padding) raises CheckpointMismatch."""
    from .. import convert

    if dtype is None:
        dtype = torch.get_default_dtype()
    S = len(devices)
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
            ns = meta["nshard"]
            if ns % S != 0:
                # a mismatched --npes would mis-assemble the blocks
                raise RuntimeError(
                    f"checkpoint in {dirpath} holds {ns} shards, which "
                    f"cannot be distributed over {S} devices; restart "
                    "with a device count that divides the checkpoint's "
                    "shard count")
            with np.load(os.path.join(slot, "state.npz")) as scal:
                stacked = {k: scal[k] for k in meta["scalar_fields"]}
            blocks = []
            for k in range(ns):
                with np.load(os.path.join(slot, f"shard{k}.npz")) as z:
                    blocks.append({n: z[n] for n in meta["sharded_fields"]})
            for n in meta["sharded_fields"]:
                stacked[n] = np.concatenate([b[n] for b in blocks])
        except (OSError, ValueError, KeyError, zipfile.BadZipFile):
            continue
        if any(v.shape[0] != S for v in stacked.values()):
            raise CheckpointMismatch(
                f"checkpoint {dirpath} holds {ns or 1} shard blocks per "
                f"field, but the solver has {S} shards")
        per = [{n: v[s] for n, v in stacked.items()} for s in range(S)]
        if like is not None:
            for s in range(S):
                _check_fits(dirpath, per[s], convert.shard_of(like, s))
        return convert.sharded_state_from_arrays(
            per, state_cls, devices, dtype), meta
    raise IOError(f"no readable checkpoint slot in {dirpath}")
