"""The port's shard builders against quinoa_tpu's, table by table, on the
CPU.

build_dg_shards, build_cg_shards and build_alecg_shards, and the three
overdecomposed builders at -u 0.5 and 0.8, give every table the JAX
package's give: the stacked per-shard geometry (padded to the largest
shard), the ownership, interface-slot and global-id tables, the
per-offset exchange tables, the chunk assignment; integer tables exactly,
float tables to 1e-15 (both are float64 numpy passes in the same order).
A port shard's DGGeom is its stacked row, with the ghost and pad
elements' fose slots at the last face where the JAX table points one
past it (a gather XLA clamps).  Without a group the builders put their
shards on the card, and raise where there is none.
"""

import numpy as np
import pytest
import torch

from quinoa_tpu.mesh import box_tet_mesh as j_box
from quinoa_tpu.parallel import overdecomp as j_od
from quinoa_tpu.parallel.alecg_spmd import build_alecg_shards as j_alecg
from quinoa_tpu.parallel.dg_shard import build_dg_shards as j_dg
from quinoa_tpu.parallel.shard import build_cg_shards as j_cg

from quinoa_tpu_torch.mesh import box_tet_mesh
from quinoa_tpu_torch.parallel import ShardGroup
from quinoa_tpu_torch.parallel import overdecomp as t_od
from quinoa_tpu_torch.parallel.alecg_spmd import build_alecg_shards
from quinoa_tpu_torch.parallel.dg_shard import build_dg_shards
from quinoa_tpu_torch.parallel.shard import build_cg_shards
from quinoa_tpu_torch.pde.dg import GEOM_TENSOR_FIELDS
from quinoa_tpu_torch.pde import cg as tcg

FTOL = 1e-15
BOX = (6, 5, 4)
HI = (1.0, 0.8, 0.6)
#: Dirichlet on the x faces, symmetry on the others
BC = {1: 1, 2: 1, 3: 2, 4: 2, 5: 2, 6: 2}


def _cpu(n):
    return ShardGroup(n, ["cpu"])


def _meshes():
    return box_tet_mesh(*BOX, hi=HI), j_box(*BOX, hi=HI)


def _same(name, got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    if np.issubdtype(want.dtype, np.integer):
        assert np.issubdtype(got.dtype, np.integer), name
        np.testing.assert_array_equal(got, want, err_msg=name)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=FTOL,
                                   err_msg=name)


def _same_halo(got, want):
    if want is None:
        assert got is None
        return
    assert got.offsets == want.offsets and got.Ls == want.Ls
    for k in range(len(want.offsets)):
        _same(f"send[{k}]", got.send[k], want.send[k])
        _same(f"rpos[{k}]", got.rpos[k], want.rpos[k])


def _check_dg(t, j):
    """Port ShardedDG t against JAX ShardedDG j."""
    for f in GEOM_TENSOR_FIELDS:
        _same(f, t.arrays[f], getattr(j.geom, f))
    for f in ("owned", "gslot", "grev", "eglobal"):
        _same(f, t.arrays[f], getattr(j, f))
    assert (t.nslots, t.nelem_global, t.nshard) == (j.nslots,
                                                     j.nelem_global,
                                                     j.nshard)
    _same_halo(t.ghalo, j.ghalo)
    Fl = t.arrays["el"].shape[1]
    for s, g in enumerate(t.geoms):
        for f in GEOM_TENSOR_FIELDS:
            want = np.asarray(getattr(j.geom, f))[s]
            if f == "fose":
                want = np.minimum(want, Fl - 1)
            _same(f"shard {s} {f}", getattr(g, f).numpy(), want)
        np.testing.assert_array_equal(t.owned[s].numpy(),
                                      np.asarray(j.owned)[s] > 0)
    for k, v in j.geom.tables.items():
        np.testing.assert_array_equal(t.geoms[0].tables[k], np.asarray(v))


def _check_cg(t, j):
    for f in tcg.GEOM_TENSOR_FIELDS:
        _same(f, t.arrays[f], getattr(j.geom, f))
    for f in ("bnd_slot", "rev_slot", "owned", "bcmask", "gids"):
        _same(f, t.arrays[f], getattr(j, f))
    assert (t.nb, t.nnode_global, t.nelem_global, t.nshard) == (
        j.nb, j.nnode_global, j.nelem_global, j.nshard)
    _same_halo(t.nhalo, j.nhalo)
    for s, g in enumerate(t.geoms):
        assert g.nnode == j.geom.nnode
        for f in tcg.GEOM_TENSOR_FIELDS:
            _same(f"shard {s} {f}", getattr(g, f).numpy(),
                  np.asarray(getattr(j.geom, f))[s])
        _same(f"shard {s} bcmask", t.bcmask[s].numpy(),
              np.asarray(j.bcmask)[s])


def _check_edges(t, j):
    for f in ("edgesT", "eA", "ensup"):
        _same(f, t.arrays[f], getattr(j, f))
    if j.exyz is not None:
        _same("exyz", t.arrays["exyz"], j.exyz)
    for s, e in enumerate(t.edget):
        _same(f"shard {s} edges", e.edges.numpy(), np.asarray(j.edgesT)[s])
        _same(f"shard {s} A", e.A.numpy(), np.asarray(j.eA)[s])
        _same(f"shard {s} ensup", e.ensup.numpy(), np.asarray(j.ensup)[s])


@pytest.fixture
def f64():
    prev = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    try:
        yield
    finally:
        torch.set_default_dtype(prev)


@pytest.mark.parametrize("ndof", [1, 4, 10])
@pytest.mark.parametrize("nshard", [3, 4])
def test_dg_shards_equal_jax(f64, nshard, ndof):
    m, jm = _meshes()
    _check_dg(build_dg_shards(m, nshard, ndof, BC, group=_cpu(nshard)),
              j_dg(jm, nshard, ndof, BC))


@pytest.mark.parametrize("algo,hierarchy", [("rcb", None), ("sfc", (2, 2))])
def test_dg_shards_algorithm_hierarchy(f64, algo, hierarchy):
    m, jm = _meshes()
    _check_dg(build_dg_shards(m, 4, 4, BC, algorithm=algo,
                              hierarchy=hierarchy, group=_cpu(4)),
              j_dg(jm, 4, 4, BC, algorithm=algo, hierarchy=hierarchy))


def test_dg_shards_explicit_partition(f64):
    m, jm = _meshes()
    ep = (np.arange(m.nelem) * 7 % 3).astype(np.int32)
    _check_dg(build_dg_shards(m, 3, 4, BC, epart=ep, group=_cpu(3)),
              j_dg(jm, 3, 4, BC, epart=ep))
    with pytest.raises(ValueError, match="epart"):
        build_dg_shards(m, 3, 4, BC, epart=ep[:-1], group=_cpu(3))


@pytest.mark.parametrize("nshard", [1, 3, 4])
def test_cg_shards_equal_jax(f64, nshard):
    m, jm = _meshes()
    bn = m.all_bnodes()
    _check_cg(build_cg_shards(m, nshard, 2, bcnodes=bn,
                              group=_cpu(nshard)),
              j_cg(jm, nshard, 2, bcnodes=bn))


@pytest.mark.parametrize("nshard", [2, 4])
def test_alecg_shards_equal_jax(f64, nshard):
    m, jm = _meshes()
    bn = m.all_bnodes()
    t, j = build_alecg_shards(m, nshard, 1, bcnodes=bn,
                              group=_cpu(nshard)), j_alecg(
        jm, nshard, 1, bcnodes=bn)
    _check_cg(t.cg, j.cg)
    _check_edges(t, j)


@pytest.mark.parametrize("u", [0.5, 0.8])
@pytest.mark.parametrize("npes", [1, 2])
def test_overdecomposed_equal_jax(f64, npes, u):
    m, jm = _meshes()
    bn = m.all_bnodes()
    cpu = _cpu(npes)
    pairs = (
        (t_od.build_overdecomposed_cg(m, npes, u, 1, bcnodes=bn, group=cpu),
         j_od.build_overdecomposed_cg(jm, npes, u, 1, bcnodes=bn), "cg"),
        (t_od.build_overdecomposed_dg(m, npes, u, 4, BC, group=cpu),
         j_od.build_overdecomposed_dg(jm, npes, u, 4, BC), "dg"),
        (t_od.build_overdecomposed_alecg(m, npes, u, 1, bcnodes=bn,
                                         group=cpu),
         j_od.build_overdecomposed_alecg(jm, npes, u, 1, bcnodes=bn),
         "alecg"),
    )
    for t, j, kind in pairs:
        assert (t.npes, t.cpd, t.assign) == (j.npes, j.cpd, j.assign), kind
        if kind == "cg":
            _check_cg(t.sharded, j.sharded)
        elif kind == "dg":
            _check_dg(t.sharded, j.sharded)
        else:
            _check_cg(t.sharded.cg, j.sharded.cg)
            _check_edges(t.sharded, j.sharded)


def test_overdecomposed_dg_weights_equal_jax(f64):
    """Dynamic load balancing under -u: chunk costs from element weights
    (active dofs) re-pack the same chunks."""
    m, jm = _meshes()
    w = np.where(np.arange(m.nelem) % 5 == 0, 4.0, 1.0)
    t = t_od.build_overdecomposed_dg(m, 2, 0.8, 4, BC, elem_weights=w,
                                     group=_cpu(2))
    j = j_od.build_overdecomposed_dg(jm, 2, 0.8, 4, BC, elem_weights=w)
    assert (t.cpd, t.assign) == (j.cpd, j.assign)
    _check_dg(t.sharded, j.sharded)


def test_builders_default_to_the_card():
    """A ShardGroup, and so each builder given none, targets the card as
    the port's single-device builders do: without one it raises."""
    m, _ = _meshes()
    bn = m.all_bnodes()
    builds = (lambda: build_dg_shards(m, 2, 1, BC),
              lambda: build_cg_shards(m, 2, 1, bcnodes=bn),
              lambda: build_alecg_shards(m, 2, 1, bcnodes=bn).cg,
              lambda: t_od.build_overdecomposed_dg(m, 2, 0.5, 1, BC).sharded)
    if torch.cuda.is_available():
        assert ShardGroup(3).devices[2].type == "cuda"
        for b in builds:
            assert {g.device.type for g in b().geoms} == {"cuda"}
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ShardGroup(3)
    for b in builds:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            b()
