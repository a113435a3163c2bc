"""The seeded mesh: positive volumes, determinism, and the face counts of
the cells' boxes."""

import numpy as np
import pytest

from benchlib import catalog, meshgen

SEEDS = (0, 1, 7, 2**31 + 11, 2**33 + 5)


def _faces(inpoel):
    tri = np.sort(inpoel[:, meshgen.TET_FACES].reshape(-1, 3), axis=1)
    return len(np.unique(tri, axis=0))


def face_count(dims):
    """Faces of a Kuhn box: (4 E + boundary faces) / 2."""
    nx, ny, nz = dims
    nb = 4 * (nx * ny + ny * nz + nx * nz)
    return (4 * 6 * nx * ny * nz + nb) // 2


@pytest.mark.parametrize("cell", catalog.cells())
def test_positive_volumes_every_seed(cell):
    c = catalog.cell(cell)
    dims = (8, 6, 5)
    for seed in SEEDS:
        m = meshgen.box(dims, c["config"]["lo"], c["config"]["hi"], c["jitter"], seed)
        assert meshgen.min_volume_ratio(m, dims, c["config"]["lo"], c["config"]["hi"]) > 0.3


def test_seed_decides_the_mesh():
    a = meshgen.box((4, 4, 4), (0, 0, 0), (1, 1, 1), 0.1, 2**31 + 3)
    b = meshgen.box((4, 4, 4), (0, 0, 0), (1, 1, 1), 0.1, 2**31 + 3)
    c = meshgen.box((4, 4, 4), (0, 0, 0), (1, 1, 1), 0.1, 2**31 + 4)
    assert np.array_equal(a["coords"], b["coords"])
    assert not np.array_equal(a["coords"], c["coords"])
    assert np.array_equal(a["inpoel"], c["inpoel"])


def test_walls_stay_and_side_sets_cover_the_boundary():
    lo, hi, dims = (0.0, 0.0, 0.0), (1.0, 0.125, 0.125), (16, 2, 2)
    m = meshgen.box(dims, lo, hi, 0.1, 5)
    x = m["coords"]
    for ss, (ax, v) in enumerate([(0, lo[0]), (0, hi[0]), (1, lo[1]), (1, hi[1]),
                                  (2, lo[2]), (2, hi[2])], 1):
        tri = m["bface"][ss]
        assert len(tri) and np.allclose(x[tri][..., ax], v)
    nb = sum(len(t) for t in m["bface"].values())
    assert nb == 2 * face_count(dims) - 4 * len(m["inpoel"])


@pytest.mark.parametrize("dims", [(3, 2, 2), (4, 3, 5)])
def test_face_count_formula(dims):
    m = meshgen.box(dims, (0, 0, 0), (1, 1, 1), 0.1, 1)
    assert _faces(m["inpoel"]) == face_count(dims)


def test_cell_sizes():
    """The cells' boxes: 1,572,864 tets each, 3,170,304 and 3,180,544
    faces."""
    for cell, faces in (("sedov_dgp1.64", 3170304), ("mm_sod_dgp1.64", 3180544)):
        dims = catalog.cell(cell)["traffic"]["cells"]
        assert 6 * int(np.prod(dims)) == 1572864
        assert face_count(dims) == faces
