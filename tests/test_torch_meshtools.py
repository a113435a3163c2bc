"""The port's mesh tools, meshconv, fileconv, -v and --trace-dir against
quinoa_tpu's, on the CPU.

- derived connectivity (gen_esup, gen_psup, gen_edsup, gen_inpoed,
  gen_esuel, gen_faces, exterior_faces, leaky_partition) and the reorder
  helpers (remap, shift_to_zero) give the JAX package's arrays;
- the mesh statistics, their echo lines and the three mesh PDF files are
  the JAX package's;
- read_stl welds as the JAX package's reader; the ExodusII pieces
  round trip (write, join) gives back the mesh and its fields, and the
  JAX package joins the port's pieces to the same result;
- meshconv (gmsh to ExodusII, an input without a boundary, --netcdf4,
  several pieces joined) and fileconv (classic to netCDF-4 and back, a
  ROOT file refused) write what the JAX CLI writes and print its -v lines
  (tests/test_io.py:128, :212, :286, :373, tests/test_control.py:126);
- the inciter's -v prints the JAX CLI's mesh statistics and writes its
  PDFs; --trace-dir writes a Chrome trace of the step loop on the CPU.
"""

import contextlib
import io
import json
import os

import numpy as np
import pytest
import torch

import quinoa_tpu.io as jio
import quinoa_tpu.mesh.derived as jder
import quinoa_tpu.mesh.reorder as jreo
import quinoa_tpu.mesh.stats as jstats
from quinoa_tpu.cli import main as j_main
from quinoa_tpu.mesh import box_tet_mesh as j_box

import quinoa_tpu_torch.io as tio
import quinoa_tpu_torch.mesh.derived as tder
import quinoa_tpu_torch.mesh.reorder as treo
import quinoa_tpu_torch.mesh.stats as tstats
from quinoa_tpu_torch.cli import main as t_main
from quinoa_tpu_torch.mesh import box_tet_mesh

BOX = (4, 3, 2)
LO, HI = (0.0, -0.5, 0.0), (1.0, 0.5, 0.3)


@pytest.fixture(scope="module")
def mesh():
    return box_tet_mesh(*BOX, lo=LO, hi=HI)


def _run(main, argv, **kw):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(argv, **kw)
    return rc, out.getvalue()


def _same_mesh(a, b):
    np.testing.assert_array_equal(a.inpoel, b.inpoel)
    np.testing.assert_array_equal(a.coords, b.coords)
    assert sorted(a.bface) == sorted(b.bface)
    for k in a.bface:
        np.testing.assert_array_equal(a.bface[k], b.bface[k])


def _same_file(a, b):
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read(), (a, b)


@pytest.mark.parametrize("name", ["gen_esup", "gen_psup", "gen_edsup",
                                  "gen_inpoed", "gen_esuel", "gen_faces",
                                  "exterior_faces"])
def test_derived_matches_jax(mesh, name):
    args = (mesh.inpoel,) if name == "gen_inpoed" else (mesh.inpoel,
                                                        mesh.nnode)
    got, want = getattr(tder, name)(*args), getattr(jder, name)(*args)
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)
        got, want = [got[k] for k in sorted(got)], [want[k] for k in
                                                     sorted(want)]
    elif not isinstance(want, tuple):
        got, want = [got], [want]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
        assert np.asarray(g).dtype == np.asarray(w).dtype


def test_leaky_partition_and_reorder_helpers_match_jax(mesh):
    esuel = tder.gen_esuel(mesh.inpoel, mesh.nnode)
    holed = esuel.copy()
    holed[np.nonzero((esuel >= 0).all(axis=1))[0][0], 0] = -1
    for e in (esuel, holed):
        assert tder.leaky_partition(e, mesh.inpoel, mesh.coords) == \
            jder.leaky_partition(e, mesh.inpoel, mesh.coords)
    assert not tder.leaky_partition(esuel, mesh.inpoel, mesh.coords)
    assert tder.leaky_partition(holed, mesh.inpoel, mesh.coords)
    perm = np.random.default_rng(0).permutation(mesh.nnode)
    np.testing.assert_array_equal(treo.remap(mesh.inpoel, perm),
                                  jreo.remap(mesh.inpoel, perm))
    got, want = treo.shift_to_zero(mesh.inpoel + 7), jreo.shift_to_zero(
        mesh.inpoel + 7)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1] == want[1] == 7


def test_mesh_statistics_and_pdfs_match_jax(tmp_path, mesh):
    chunks = [40, 32, 72]
    got = tstats.mesh_statistics(mesh, chunks)
    want = jstats.mesh_statistics(j_box(*BOX, lo=LO, hi=HI), chunks)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    assert tstats.format_mesh_statistics(got) == \
        jstats.format_mesh_statistics(want)
    (tmp_path / "t").mkdir()
    (tmp_path / "j").mkdir()
    tstats.write_mesh_pdfs(got, str(tmp_path / "t"))
    jstats.write_mesh_pdfs(want, str(tmp_path / "j"))
    for f in ("mesh_edge_pdf.txt", "mesh_vol_pdf.txt", "mesh_ntet_pdf.txt"):
        _same_file(tmp_path / "t" / f, tmp_path / "j" / f)


def test_read_stl_matches_jax(tmp_path):
    p = tmp_path / "t.stl"
    p.write_text("solid box\n"
                 "facet normal 0 0 1\nouter loop\n"
                 "vertex 0 0 0\nvertex 1 0 0\nvertex 0 1 0\n"
                 "endloop\nendfacet\n"
                 "facet normal 0 0 1\nouter loop\n"
                 "vertex 1 0 0\nvertex 1 1 0\nvertex 0 1 0\n"
                 "endloop\nendfacet\nendsolid box\n")
    for weld in (0.0, 1e-9):
        got, want = tio.read_stl(str(p), weld), jio.read_stl(str(p), weld)
        assert got.tri.shape == (2, 3) and got.coords.shape == (4, 3)
        np.testing.assert_array_equal(got.tri, want.tri)
        np.testing.assert_array_equal(got.coords, want.coords)
    bad = tmp_path / "b.stl"
    bad.write_text("facet\n")
    with pytest.raises(ValueError):
        tio.read_stl(str(bad))


def _parts(mesh, n):
    return np.arange(mesh.nelem) * n // mesh.nelem


def test_pieces_round_trip_and_jax_join(tmp_path, mesh):
    rng = np.random.default_rng(0)
    nf = {"c0": rng.normal(size=mesh.nnode)}
    ef = {"r": rng.normal(size=mesh.nelem)}
    parts = _parts(mesh, 4)
    paths = tio.write_exodus_pieces(str(tmp_path / "out"), mesh, parts,
                                    node_fields=nf, elem_fields=ef,
                                    time=0.125, it=7)
    assert [os.path.basename(p) for p in paths] == [
        f"out.e-s.7.4.{p}" for p in range(4)]
    jpaths = jio.write_exodus_pieces(str(tmp_path / "jout"),
                                     j_box(*BOX, lo=LO, hi=HI), parts,
                                     node_fields=nf, elem_fields=ef,
                                     time=0.125, it=7)
    for a, b in zip(paths, jpaths):
        _same_file(a, b)
    lm, nmap, emap = tio.extract_piece(mesh, parts, 2)
    jm, jnmap, jemap = jio.extract_piece(mesh, parts, 2)
    _same_mesh(lm, jm)
    np.testing.assert_array_equal(nmap, jnmap)
    np.testing.assert_array_equal(emap, jemap)
    for join in (tio.join_exodus_pieces, jio.join_exodus_pieces):
        m2, nf2, ef2, t2 = join(paths)
        np.testing.assert_array_equal(m2.inpoel, mesh.inpoel)
        np.testing.assert_array_equal(m2.coords, mesh.coords)
        np.testing.assert_array_equal(nf2["c0"], nf["c0"])
        np.testing.assert_array_equal(ef2["r"], ef["r"])
        assert t2 == 0.125
        assert sum(len(v) for v in m2.bface.values()) == sum(
            len(v) for v in mesh.bface.values())


def _both(tmp_path, argv_of):
    """argv_of(directory) through both CLIs, each in its own directory:
    [(rc, stdout, directory)] of the port and the JAX package."""
    out = []
    for tag, main, kw in (("t", t_main, {"device": "cpu"}), ("j", j_main,
                                                             {})):
        d = tmp_path / tag
        d.mkdir(exist_ok=True)
        rc, text = _run(main, argv_of(str(d)), **kw)
        out.append((rc, text.replace(str(d), "<d>"), str(d)))
    return out


@pytest.mark.parametrize("case", ["gmsh_to_exo", "no_boundary", "netcdf4",
                                  "to_netgen"])
def test_meshconv_matches_jax_cli(tmp_path, mesh, case):
    src = str(tmp_path / ("in.msh" if case != "no_boundary" else "in.exo"))
    if case == "no_boundary":
        bare = box_tet_mesh(*BOX, lo=LO, hi=HI)
        bare.bface = {}
        bare.bnode = {}
        tio.write_exodus(src, bare)
    else:
        tio.write_gmsh(src, mesh)
    dst = {"to_netgen": "out.mesh"}.get(case, "out.exo")
    tail = ["--netcdf4"] if case == "netcdf4" else []
    (rc, text, td), (jrc, jtext, jd) = _both(
        tmp_path, lambda d: ["meshconv", "-i", src, "-o",
                             os.path.join(d, dst), "-v", *tail])
    assert rc == jrc == 0 and text == jtext
    assert text.startswith("meshconv: ") and "boundary tris" in text
    got = tio.read_mesh(os.path.join(td, dst))
    want = jio.read_mesh(os.path.join(jd, dst))
    _same_mesh(got, want)
    assert got.nelem == mesh.nelem and got.bface
    if case == "netcdf4":
        with open(os.path.join(td, dst), "rb") as fh:
            assert fh.read(4) == b"\x89HDF"
    if case == "no_boundary":
        np.testing.assert_array_equal(
            got.bface[1], tder.exterior_faces(mesh.inpoel, mesh.nnode))


def test_meshconv_joins_pieces_as_jax_cli(tmp_path, mesh):
    ef = {"r": np.arange(mesh.nelem, dtype=float)}
    paths = tio.write_exodus_pieces(str(tmp_path / "o"), mesh,
                                    _parts(mesh, 3), elem_fields=ef,
                                    time=0.5, it=2)
    (rc, text, td), (jrc, jtext, jd) = _both(
        tmp_path, lambda d: ["meshconv", "-i", *paths, "-o",
                             os.path.join(d, "joined.exo"), "-v"])
    assert rc == jrc == 0 and text == jtext
    assert text.startswith("meshconv: joined 3 pieces")
    _same_file(os.path.join(td, "joined.exo"), os.path.join(jd,
                                                            "joined.exo"))
    names, times, vals = tio.read_exodus_elem_fields(
        os.path.join(td, "joined.exo"))
    assert names == ["r"] and times[-1] == 0.5
    np.testing.assert_array_equal(vals[-1, 0], ef["r"])


def test_fileconv_matches_jax_cli(tmp_path, mesh):
    src = str(tmp_path / "in.exo")
    nf = {"c0_numerical": np.linspace(0.0, 1.0, mesh.nnode)}
    ef = {"r": np.arange(mesh.nelem, dtype=float)}
    tio.write_exodus(src, mesh, node_fields=nf, elem_fields=ef, time=0.5)
    (rc, text, td), (jrc, jtext, jd) = _both(
        tmp_path, lambda d: ["fileconv", "-i", src, "-o",
                             os.path.join(d, "out4.exo"), "-v"])
    assert rc == jrc == 0 and text == jtext
    dst = os.path.join(td, "out4.exo")
    with open(dst, "rb") as fh:
        assert fh.read(4) == b"\x89HDF"
    for read in (tio.read_exodus_fields, tio.read_exodus_elem_fields):
        got, want = read(dst), read(os.path.join(jd, "out4.exo"))
        assert got[0] == want[0]
        np.testing.assert_array_equal(got[1], want[1])
        np.testing.assert_array_equal(got[2], want[2])
    names, times, vals = tio.read_exodus_fields(dst)
    assert names == ["c0_numerical"] and times[-1] == 0.5
    np.testing.assert_array_equal(vals[-1, 0], nf["c0_numerical"])
    (rc, _, td), (jrc, _, jd) = _both(
        tmp_path, lambda d: ["fileconv", "-i", os.path.join(d, "out4.exo"),
                             "-o", os.path.join(d, "back.exo")])
    assert rc == jrc == 0
    _same_file(os.path.join(td, "back.exo"), os.path.join(jd, "back.exo"))
    with open(os.path.join(td, "back.exo"), "rb") as fh:
        assert fh.read(3) == b"CDF"
    bad = tmp_path / "x.root"
    bad.write_bytes(b"root\x00\x00\x00\x00")
    assert t_main(["fileconv", "-i", str(bad), "-o", "y"]) == 1


DECK = """inciter
  nstep 2 cfl 0.8
  scheme diagcg
  transport physics advection problem slot_cyl depvar c
    bc_dirichlet sideset 1 2 3 4 5 6 end end
  end
  diagnostics interval 1 end
end
"""


def test_inciter_verbose_statistics_match_jax_cli(tmp_path, monkeypatch):
    """-v: the three mesh statistics lines and the three PDF files in the
    working directory are the JAX CLI's; the run is otherwise unchanged."""
    deck, mp = tmp_path / "run.q", str(tmp_path / "box.exo")
    deck.write_text(DECK)
    tio.write_exodus(mp, box_tet_mesh(*BOX, lo=LO, hi=(1.0, 1.0, 0.5)))
    stats = {}
    prev = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    try:
        for tag, main, kw in (("t", t_main, {"device": "cpu"}),
                              ("j", j_main, {})):
            d = tmp_path / tag
            d.mkdir()
            monkeypatch.chdir(d)
            rc, text = _run(main, ["inciter", "-c", str(deck), "-i", mp,
                                   "--diag", "diag", "-o", "out", "-b",
                                   "-v"], **kw)
            assert rc == 0
            stats[tag] = [ln for ln in text.splitlines()
                          if ln.startswith("Mesh statistics")]
    finally:
        torch.set_default_dtype(prev)
    assert len(stats["t"]) == 3 and stats["t"] == stats["j"]
    for f in ("mesh_edge_pdf.txt", "mesh_vol_pdf.txt", "mesh_ntet_pdf.txt",
              "diag"):
        _same_file(tmp_path / "t" / f, tmp_path / "j" / f)


def test_trace_dir_writes_a_trace_on_the_cpu(tmp_path):
    """--trace-dir records the step loop with torch.profiler (CPU activity
    on the CPU) as a Chrome trace; the diagnostics equal an untraced
    run's."""
    deck, mp = tmp_path / "run.q", str(tmp_path / "box.exo")
    deck.write_text(DECK)
    tio.write_exodus(mp, box_tet_mesh(*BOX, lo=LO, hi=(1.0, 1.0, 0.5)))
    base = ["inciter", "-c", str(deck), "-i", mp, "-b"]
    tr = tmp_path / "trace"
    assert t_main(base + ["--diag", str(tmp_path / "a"), "--trace-dir",
                          str(tr)], device="cpu") == 0
    assert t_main(base + ["--diag", str(tmp_path / "b")],
                  device="cpu") == 0
    _same_file(tmp_path / "a", tmp_path / "b")
    with open(tr / "trace.json") as fh:
        events = json.load(fh)["traceEvents"]
    names = {e.get("name", "") for e in events}
    assert any(n.startswith("aten::") for n in names), sorted(names)[:20]
