"""The port's mesh and field I/O against quinoa_tpu/io and
quinoa_tpu/inciter/fieldout.

- a file written by either package reads back in the other with the same
  coords, inpoel, bface and bnode, for ExodusII classic, Gmsh 2.2 ASCII
  and binary, and Netgen neutral, and format detection agrees;
- inline ASC and HyperMesh text reads the same in both packages;
- netCDF-4 (HDF5) ExodusII written by either package reads back in the
  other where h5py imports; a classic file never imports h5py;
- the diagnostics writer writes byte-equal files in every float format;
- plot_fields gives equal arrays (rtol 1e-13) for transport, compflow and
  multimat data made from a numpy seed, with the same names.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import quinoa_tpu.io as jio
from quinoa_tpu.inciter.fieldout import plot_fields as j_plot
from quinoa_tpu.mesh import box_tet_mesh as j_box
from quinoa_tpu.pde.cg import CGTransport as JCGTransport
from quinoa_tpu.pde.dg_compflow import DGCompFlow as JDGCompFlow
from quinoa_tpu.pde.multimat import MultiMatSystem as JMultiMat
from quinoa_tpu.pde.problems import SlotCyl as JSlotCyl
from quinoa_tpu.pde.problems import VorticalFlow as JVorticalFlow
from quinoa_tpu.pde.problems.multimat import (
    MMInterfaceAdvection as JMMInterface)

import quinoa_tpu_torch.io as tio
from quinoa_tpu_torch.inciter.fieldout import plot_fields as t_plot
from quinoa_tpu_torch.mesh import box_tet_mesh as t_box
from quinoa_tpu_torch.pde.cg import CGTransport as TCGTransport
from quinoa_tpu_torch.pde.dg_compflow import DGCompFlow as TDGCompFlow
from quinoa_tpu_torch.pde.multimat import MultiMatSystem as TMultiMat
from quinoa_tpu_torch.pde.problems import MMInterfaceAdvection as TMMInterface
from quinoa_tpu_torch.pde.problems import SlotCyl as TSlotCyl
from quinoa_tpu_torch.pde.problems import VorticalFlow as TVorticalFlow

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIELD_RTOL = 1e-13
PKG = {"jax": (jio, j_box), "port": (tio, t_box)}


def _same_mesh(a, b):
    """Equal coords, inpoel, side sets (triangles in order) and bnode."""
    np.testing.assert_array_equal(a.coords, b.coords)
    np.testing.assert_array_equal(a.inpoel, b.inpoel)
    assert sorted(a.bface) == sorted(b.bface)
    for ss in a.bface:
        np.testing.assert_array_equal(a.bface[ss], b.bface[ss])
    assert sorted(a.bnode) == sorted(b.bnode)
    for ss in a.bnode:
        np.testing.assert_array_equal(a.bnode[ss], b.bnode[ss])


#: (format, extension, writer name, writer keywords)
FORMATS = [("exodus", "exo", "write_exodus", {}),
           ("gmsh", "msh", "write_gmsh", {}),
           ("gmsh", "msh", "write_gmsh", {"binary": True}),
           ("netgen", "mesh", "write_netgen", {})]


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("fmt,ext,wname,kw", FORMATS,
                         ids=["exodus", "gmsh", "gmsh_binary", "netgen"])
def test_mesh_files_cross_read(tmp_path, writer, fmt, ext, wname, kw):
    """A file one package writes reads back the same in both, and the
    read mesh equals the one the writer's reader returns."""
    wmod, box = PKG[writer]
    path = str(tmp_path / f"m.{ext}")
    getattr(wmod, wname)(path, box(3, 2, 2, hi=(1.0, 0.5, 0.5)), **kw)
    assert tio.detect_format(path) == jio.detect_format(path) == fmt
    assert tio.meshfactory.format_from_extension(path) == \
        jio.meshfactory.format_from_extension(path)
    _same_mesh(tio.read_mesh(path), jio.read_mesh(path))


@pytest.mark.parametrize("fmt,ext,wname,kw", FORMATS,
                         ids=["exodus", "gmsh", "gmsh_binary", "netgen"])
def test_mesh_files_byte_equal(tmp_path, fmt, ext, wname, kw):
    """Both packages write the same bytes for the same mesh."""
    paths = {}
    for name, (mod, box) in PKG.items():
        paths[name] = str(tmp_path / f"{name}.{ext}")
        getattr(mod, wname)(paths[name], box(2, 2, 3, hi=(0.5, 0.5, 1.0)),
                            **kw)
    with open(paths["jax"], "rb") as a, open(paths["port"], "rb") as b:
        assert a.read() == b.read()


def test_exodus_fields_cross_read(tmp_path):
    """Nodal and element fields, time and number maps written by the port
    read back the same through both packages' readers."""
    mesh = t_box(2, 2, 2)
    rng = np.random.default_rng(3)
    nf = {"a": rng.random(mesh.nnode), "b_numerical": rng.random(mesh.nnode)}
    ef = {"density_numerical": rng.random(mesh.nelem)}
    p = str(tmp_path / "f.exo")
    tio.write_exodus(p, mesh, node_fields=nf, elem_fields=ef, time=0.375,
                     node_num_map=np.arange(mesh.nnode)[::-1],
                     elem_num_map=np.arange(mesh.nelem) + 5)
    for fn in ("read_exodus_fields", "read_exodus_elem_fields",
               "read_exodus_maps"):
        a, b = getattr(tio, fn)(p), getattr(jio.exodus, fn)(p)
        for x, y in zip(a, b):
            if isinstance(x, list):
                assert x == y
            else:
                np.testing.assert_array_equal(x, y)


ASC = ("*ndim 3\n*numNodeSets 0\n*numSideSets 0\n*nodes 5\n"
       "1 0 0 0\n2 1 0 0\n3 0 1 0\n4 0 0 1\n5 1 1 1\n"
       "*cells 2\n1 0 0 4 1 3 2\n2 0 0 5 2 3 4\n")


def test_asc_reads_the_same(tmp_path):
    p = tmp_path / "m.asc"
    p.write_text(ASC)
    assert tio.detect_format(str(p)) == jio.detect_format(str(p)) == "asc"
    _same_mesh(tio.read_mesh(str(p)), jio.read_mesh(str(p)))


def test_hypermesh_reads_the_same(tmp_path):
    (tmp_path / "m.xml").write_text(
        '<mesh>\n <coordinates file="pts.txt"/>\n'
        ' <element_set file="conn.txt" topology="four_node_tet"/>\n'
        '</mesh>\n')
    (tmp_path / "pts.txt").write_text(
        "1 0 0 0\n2 1 0 0\n3 0 1 0\n4 0 0 1\n5 1 1 1\n")
    # 1-based ids, the second tet inverted on purpose
    (tmp_path / "conn.txt").write_text("1 1 2 3 4\n2 2 3 5 4\n")
    p = str(tmp_path / "m.xml")
    assert tio.detect_format(p) == jio.detect_format(p) == "hypermesh"
    _same_mesh(tio.read_mesh(p), jio.read_mesh(p))


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_netcdf4_exodus_cross_read(tmp_path, writer):
    pytest.importorskip("h5py")
    wmod, box = PKG[writer]
    mesh = box(2, 3, 2)
    p = str(tmp_path / "m4.exo")
    nf = {"c0_numerical": np.linspace(0.0, 1.0, mesh.nnode)}
    wmod.write_exodus(p, mesh, node_fields=nf, time=0.25, fmt="netcdf4")
    with open(p, "rb") as fh:
        assert fh.read(4) == b"\x89HDF"
    _same_mesh(tio.read_exodus(p), jio.read_exodus(p))
    a, b = tio.read_exodus_fields(p), jio.exodus.read_exodus_fields(p)
    assert a[0] == b[0] == ["c0_numerical"]
    np.testing.assert_array_equal(a[2], b[2])


def test_classic_exodus_never_imports_h5py(tmp_path):
    """Writing and reading a classic file works in an interpreter where
    h5py cannot be imported (as on a machine without it)."""
    code = (
        "import sys\n"
        "class NoH5:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] == 'h5py':\n"
        "            raise ImportError('h5py imported')\n"
        "sys.modules.pop('h5py', None)\n"
        "sys.meta_path.insert(0, NoH5())\n"
        "from quinoa_tpu_torch.io import read_mesh, write_exodus\n"
        "from quinoa_tpu_torch.mesh import box_tet_mesh\n"
        "write_exodus(sys.argv[1], box_tet_mesh(2, 2, 2),\n"
        "             elem_fields={'a': [0.0] * 48})\n"
        "m = read_mesh(sys.argv[1])\n"
        "print(m.nelem, len(m.bface), 'h5py' in sys.modules)\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (REPO, os.environ.get("PYTHONPATH")) if p))
    res = subprocess.run([sys.executable, "-c", code,
                          str(tmp_path / "c.exo")], capture_output=True,
                         text=True, cwd=REPO, env=env, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.split() == ["48", "6", "False"]


@pytest.mark.parametrize("fmt,precision", [("scientific", 12),
                                           ("fixed", 6), ("default", 8),
                                           ("scientific", 4)])
def test_diag_writer_bytes_equal(tmp_path, fmt, precision):
    rng = np.random.default_rng(5)
    rows = [(it, float(t), float(dt), list(a), list(b) if it % 2 else None,
             list(c) if it % 2 else None)
            for it, t, dt, a, b, c in zip(
                range(1, 4), rng.random(3), rng.random(3) * 1e-3,
                rng.normal(size=(3, 3)) * 1e5, rng.random((3, 3)) * 1e-9,
                rng.random((3, 3)))]
    paths = []
    for mod in (jio, tio):
        paths.append(str(tmp_path / f"diag_{mod.__name__}"))
        w = mod.DiagWriter(paths[-1], ncomp=3, fmt=fmt, precision=precision)
        for r in rows:
            w.write(*r)
        w.close()
    with open(paths[0], "rb") as a, open(paths[1], "rb") as b:
        assert a.read() == b.read()


def _check_fields(got, want):
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_allclose(got[k], np.asarray(want[k]),
                                   rtol=FIELD_RTOL, atol=0, err_msg=k)


@pytest.fixture
def f64():
    prev = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    try:
        yield
    finally:
        torch.set_default_dtype(prev)


def test_plot_fields_transport(f64):
    rng = np.random.default_rng(7)
    u, xyz = rng.random((2, 40)), rng.random((3, 40))
    em = rng.random((2, 40))
    js, ts = JCGTransport(JSlotCyl(ncomp=2)), TCGTransport(TSlotCyl(ncomp=2))
    for kw in ({}, {"exact_mean": em}, {"analytic": False}):
        _check_fields(t_plot("transport", ts, u, xyz, 0.3, **kw),
                      j_plot("transport", js, u, xyz, 0.3, **kw))


def test_plot_fields_compflow(f64):
    rng = np.random.default_rng(11)
    n = 50
    u = np.stack([1.0 + rng.random(n), *rng.normal(size=(3, n)),
                  10.0 + rng.random(n)])
    xyz = rng.random((3, n)) - 0.5
    js, ts = JDGCompFlow(JVorticalFlow()), TDGCompFlow(TVorticalFlow())
    got = t_plot("compflow", ts, u, xyz, 0.0)
    assert "pressure_analytical" in got
    _check_fields(got, j_plot("compflow", js, u, xyz, 0.0))
    # a torch tensor in, the same numpy arrays out
    _check_fields(t_plot("compflow", ts, torch.from_numpy(u), xyz, 0.0), got)


def test_plot_fields_multimat(f64):
    rng = np.random.default_rng(13)
    nmat, n = 3, 30
    a = rng.random((nmat, n)) + 0.1
    a /= a.sum(axis=0)
    u = np.concatenate([a, a * (1.0 + rng.random((nmat, n))),
                        rng.normal(size=(3, n)),
                        a * (2e5 + rng.random((nmat, n)))])
    js, ts = JMultiMat(JMMInterface()), TMultiMat(TMMInterface())
    got = t_plot("multimat", ts, u, rng.random((3, n)), 0.0)
    assert [k for k in got if k.startswith("volfrac")] == [
        "volfrac1_numerical", "volfrac2_numerical", "volfrac3_numerical"]
    _check_fields(got, j_plot("multimat", js, u, rng.random((3, n)), 0.0))
    with pytest.raises(ValueError, match="unknown pde"):
        t_plot("walker", ts, u, rng.random((3, n)), 0.0)


def test_meshfactory_dispatch_matches(tmp_path):
    """read_mesh/write_mesh pick the format from content and extension as
    the JAX package does, and refuse what it refuses."""
    mesh = t_box(2, 2, 1)
    for ext in ("exo", "e", "g", "msh", "mesh", "neu"):
        p = str(tmp_path / f"m.{ext}")
        tio.write_mesh(p, mesh)
        assert tio.detect_format(p) == jio.detect_format(p)
        _same_mesh(tio.read_mesh(p), jio.read_mesh(p))
    for bad in ("m.vtk", "m.osh"):
        for mod in (tio, jio):
            with pytest.raises(ValueError):
                if bad.endswith(".osh"):
                    mod.detect_format(str(tmp_path / bad))
                else:
                    mod.write_mesh(str(tmp_path / bad), mesh)
