"""A small jittered box for the tests that hold the p-adaptive solver's
fused limit + volume route against its split route."""

import numpy as np

from quinoa_tpu_torch.mesh import box_tet_mesh


def jittered_box(n=(6, 6, 4), hi=(0.6, 0.6, 0.4), jitter=0.1, seed=5):
    """The port's box mesh with every interior node moved by up to
    jitter times the cell's edge along each axis (the walls stay)."""
    mesh = box_tet_mesh(*n, hi=hi)
    inner = np.ones(len(mesh.coords), bool)
    inner[mesh.all_bnodes()] = False
    h = np.asarray(hi, float) / np.asarray(n)
    move = np.random.default_rng(seed).uniform(-jitter, jitter,
                                               (int(inner.sum()), 3))
    coords = mesh.coords.copy()
    coords[inner] += move * h
    mesh.coords = coords
    return mesh
