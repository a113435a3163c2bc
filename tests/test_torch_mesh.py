"""The port's own host mesh passes against quinoa_tpu's: the box mesh (its
coordinates, connectivity and side sets), gen_esuel, gen_faces,
gen_inpoed, tet_geometry, nodal_volumes, coords_cache, build_fose and
face_xi.

The JAX package runs its native C++ passes where they are built
(quinoa_tpu.native), the port numpy written in the same operation order,
so every array is compared for exact equality on two small boxes.
"""

import numpy as np
import pytest

from quinoa_tpu.mesh import box_tet_mesh as j_box
from quinoa_tpu.mesh.derived import gen_esuel as j_esuel
from quinoa_tpu.mesh.derived import gen_faces as j_faces
from quinoa_tpu.mesh.derived import gen_inpoed as j_inpoed
from quinoa_tpu.mesh.geometry import nodal_volumes as j_nodal_volumes
from quinoa_tpu.mesh.geometry import tet_geometry as j_tet_geometry
from quinoa_tpu.native import build_fose as j_native_fose
from quinoa_tpu.native import face_xi as j_native_face_xi
from quinoa_tpu.ops.quadrature import gauss_tri
from quinoa_tpu.pde.cg import coords_cache_np as j_coords_cache

from quinoa_tpu_torch.mesh import UnsMesh, box_tet_mesh
from quinoa_tpu_torch.mesh.derived import gen_esuel, gen_faces, gen_inpoed
from quinoa_tpu_torch.mesh.geometry import nodal_volumes, tet_geometry
from quinoa_tpu_torch.pde.cg import coords_cache_np
from quinoa_tpu_torch.pde.dg import build_fose, face_xi

BOXES = {
    "unit": ((3, 4, 2), (0.0, 0.0, 0.0), (1.0, 1.0, 0.5)),
    "centred": ((5, 3, 4), (-0.5, -0.5, -0.5), (0.5, 0.5, 0.5)),
}


@pytest.fixture(scope="module", params=sorted(BOXES))
def boxes(request):
    n, lo, hi = BOXES[request.param]
    return j_box(*n, lo=lo, hi=hi), box_tet_mesh(*n, lo=lo, hi=hi)


def _faces_lr(mesh):
    """The el-sorted left/right element lists of build_dggeom."""
    fd = gen_faces(mesh.inpoel, mesh.nnode)
    el = fd["esuf"][:, 0].astype(np.int64)
    er = np.where(fd["esuf"][:, 1] < 0, el, fd["esuf"][:, 1]).astype(
        np.int64)
    order = np.argsort(el, kind="stable")
    return fd["inpofa"], el[order], er[order]


def test_box_mesh_matches(boxes):
    jm, tm = boxes
    assert isinstance(tm, UnsMesh)
    np.testing.assert_array_equal(tm.coords, jm.coords)
    np.testing.assert_array_equal(tm.inpoel, jm.inpoel)
    assert tm.inpoel.dtype == jm.inpoel.dtype == np.int32
    assert sorted(tm.bface) == sorted(jm.bface) == list(range(1, 7))
    for ss in jm.bface:
        np.testing.assert_array_equal(tm.bface[ss], jm.bface[ss])
        np.testing.assert_array_equal(tm.bnode[ss], jm.bnode[ss])
    np.testing.assert_array_equal(tm.all_bnodes(), jm.all_bnodes())


def test_connectivity_matches(boxes):
    """gen_esuel, every gen_faces table and gen_inpoed."""
    jm, tm = boxes
    np.testing.assert_array_equal(gen_esuel(tm.inpoel, tm.nnode),
                                  j_esuel(jm.inpoel, jm.nnode))
    got, want = gen_faces(tm.inpoel, tm.nnode), j_faces(jm.inpoel, jm.nnode)
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    ed = gen_inpoed(tm.inpoel)
    assert ed.dtype == np.int32
    np.testing.assert_array_equal(ed, j_inpoed(jm.inpoel))


def test_geometry_matches(boxes):
    """tet_geometry, nodal_volumes and the coords cache, bit for bit."""
    jm, tm = boxes
    J, grad = tet_geometry(tm.coords, tm.inpoel)
    jJ, jgrad = j_tet_geometry(jm.coords, jm.inpoel)
    np.testing.assert_array_equal(J, jJ)
    np.testing.assert_array_equal(grad, jgrad)
    np.testing.assert_array_equal(
        nodal_volumes(tm.coords, tm.inpoel, tm.nnode, J=J),
        j_nodal_volumes(jm.coords, jm.inpoel, jm.nnode, J=jJ))
    cn, ctr = coords_cache_np(np.ascontiguousarray(tm.coords.T),
                              np.ascontiguousarray(tm.inpoel.T))
    jcn, jctr = j_coords_cache(jm.coords.T, jm.inpoel.T)
    np.testing.assert_array_equal(cn, jcn)
    np.testing.assert_array_equal(ctr, jctr)


def _sequential_fose(el, er, nelem):
    """The JAX build_dggeom's slot-fill loop."""
    fose = np.zeros((4, nelem), dtype=np.int32)
    fsideR = np.zeros((4, nelem))
    slot = np.zeros(nelem, dtype=np.int64)
    for f in range(len(el)):
        fose[slot[el[f]], el[f]] = f
        slot[el[f]] += 1
        if er[f] != el[f]:
            fose[slot[er[f]], er[f]] = f
            fsideR[slot[er[f]], er[f]] = 1.0
            slot[er[f]] += 1
    return fose, fsideR


def test_face_tables_match(boxes):
    """build_fose and face_xi against the JAX package's native passes (its
    build_dggeom's numpy loop and einsum where the library is not
    built)."""
    jm, tm = boxes
    inpofa, el, er = _faces_lr(tm)
    fose, fsideR = build_fose(el, er, tm.nelem)
    want = j_native_fose(el, er, tm.nelem)
    if want is None:
        want = _sequential_fose(el, er, tm.nelem)
    np.testing.assert_array_equal(fose, want[0])
    np.testing.assert_array_equal(fsideR, want[1])

    tp, _ = gauss_tri(3)
    shp = np.stack([1.0 - tp[:, 0] - tp[:, 1], tp[:, 0], tp[:, 1]], axis=1)
    c, ip = tm.coords, tm.inpoel
    n0 = c[ip[:, 0]]
    jinv = np.linalg.inv(np.stack([c[ip[:, 1]] - n0, c[ip[:, 2]] - n0,
                                   c[ip[:, 3]] - n0], axis=2))
    got = face_xi(c, inpofa, shp, jinv, n0, el, er)
    want = j_native_face_xi(c, inpofa, shp, jinv, n0, el, er)
    if want is None:
        gp = np.einsum("gi,fid->fgd", shp, c[inpofa])
        want = [np.einsum("fij,fgj->fgi", jinv[e], gp - n0[e][:, None, :])
                for e in (el, er)]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_build_fose_rejects_malformed():
    """An element that does not own exactly four face slots raises."""
    el = np.array([0, 0, 0], dtype=np.int64)
    with pytest.raises(ValueError, match="4 face slots"):
        build_fose(el, el, 1)
