"""The port's walker against quinoa_tpu's, on the CPU in float64.

Every SDE system (the 16 classes, with each coefficient policy the JAX
package has) and every init policy runs in quinoa_tpu (jax x64 from
tests/conftest.py) and in quinoa_tpu_torch (torch float64, set and
restored) from the same seed at npar NPAR:

- the initial ensemble and the ensemble after one step agree to rtol
  1e-12 / atol 1e-14, after 10 steps to rtol 1e-10 / atol 1e-13: the
  Gaussian increments are the same draws to a few ulps (XLA fuses
  multiply-adds that torch rounds twice), and the gamma-based init
  policies the same samples;
- moments (ordinary and central, the ("C",) + term key rule) and 1-, 2-
  and 3-D PDFs (given and data extents, central flags) of one particle
  array agree: moments to rtol 1e-12, PDF bins and counts exactly;
- Walker.run across two calls continues the step counter; the run's
  moment history matches the JAX walker's;
- a JAX walker's state handed over mid-run (convert.
  walker_state_from_arrays) continues in the port as in the JAX package;
- the PDF writers (txt, gmsh with both centerings, exodus) write the JAX
  package's files from one PDF, and the stat writer its rows.

WrightFisher runs from a state off the simplex (components summing to
0.75), where its diffusion matrix diag(Y) - Y Y^T is positive definite.
On the simplex that matrix is singular, its zero eigenvalue comes out of
eigh as +-1e-17, and the square root turns that round-off into 1e-9
after one step (measured: 1.0e-9); the step after, the sum is off 1 by
that much and the difference grows to 1e-6, then 1e-3 by step 10, in
either package against the other.  test_wright_fisher_on_the_simplex
holds that one step to WF_SIMPLEX_ATOL.
"""

import dataclasses

import numpy as np
import pytest
import torch

import quinoa_tpu.diffeq as jdq
import quinoa_tpu.diffeq.initpolicy as jip
from quinoa_tpu.diffeq import hydro as jhydro
from quinoa_tpu.io import (TxtStatWriter as JTxtStatWriter,
                           write_pdf_exodus as j_exo,
                           write_pdf_gmsh as j_gmsh, write_pdf_txt as j_txt)
from quinoa_tpu.statistics import estimate_moments as j_moments
from quinoa_tpu.statistics import estimate_pdf as j_pdf
from quinoa_tpu.walker import Walker as JWalker

import quinoa_tpu_torch.diffeq as tdq
import quinoa_tpu_torch.diffeq.initpolicy as tip
from quinoa_tpu_torch import convert
from quinoa_tpu_torch.base.table import Table
from quinoa_tpu_torch.diffeq import hydro as thydro
from quinoa_tpu_torch.io import (TxtStatWriter, write_pdf_exodus,
                                 write_pdf_gmsh, write_pdf_txt)
from quinoa_tpu_torch.statistics import (estimate_moments, estimate_pdf,
                                         moments_to_host)
from quinoa_tpu_torch.walker import Walker

NPAR = 512
DT = 0.01
SEED = 5
STEP_RTOL, STEP_ATOL = 1e-12, 1e-14
RUN_RTOL, RUN_ATOL = 1e-10, 1e-13
MOM_RTOL = 1e-12
WF_SIMPLEX_ATOL = 1e-8

_BETA = [(2.0, 2.0, 0.0, 1.0)]
_MIX = [[(0.05, 0.5), (0.95, 0.5)]]


def _systems(dq, hydro):
    """name -> [(system, (init policy name, its arguments))]: every
    class of quinoa_tpu.diffeq with each coefficient policy, in the
    package ``dq`` with its hydro tables."""
    hts = lambda n: hydro.hydro_table(f"eq_{n}")
    hp = lambda n: hydro.hydro_table(f"prod_{n}")
    g2 = ("jointgaussian", [(0.3, 0.1), (0.1, 0.2)])
    out = {
        "diag_ou": [(dq.DiagOrnsteinUhlenbeck(
            depvar="y", sigmasq=(0.25, 0.5), theta=(1.0, 2.0),
            mu=(0.5, -0.2)), g2)],
        "ou": [(dq.OrnsteinUhlenbeck(
            depvar="y", sigmasq=((0.25, 0.15), (0.15, 0.25)),
            theta=(1.0, 1.5), mu=(0.0, 0.3)),
            ("jointcorrgaussian",
             ([0.1, -0.1], [[0.2, 0.05], [0.05, 0.1]])))],
        "beta": [(dq.Beta(depvar="y", b=(1.0, 0.5), S=(0.6, 0.3),
                          kappa=(0.1, 0.2)),
                  ("jointbeta", _BETA + [(3.0, 2.0, 0.1, 0.8)]))],
        "numfracbeta": [(dq.NumberFractionBeta(
            depvar="x", b=(0.4,), S=(0.5,), kappa=(0.1,), rho2=(2.0,),
            rcomma=(0.3,)), ("jointbeta", _BETA))],
        "massfracbeta": [(dq.MassFractionBeta(
            depvar="x", b=(0.4,), S=(0.5,), kappa=(0.1,), rho2=(2.0,),
            r=(0.3,)), ("jointbeta", [(2.0, 3.0, 0.0, 1.0)]))],
        "mixnumfracbeta": [(dq.MixNumberFractionBeta(
            depvar="x", bprime=(2.0,), S=(0.5,), kprime=(0.5,), rho2=(1.0,),
            rcomma=(0.5,)), ("jointdelta", _MIX))],
        "dirichlet": [(dq.Dirichlet(depvar="y", b=(1.0, 1.5), S=(0.4, 0.4),
                                    kappa=(0.5, 0.7)),
                       ("jointdelta", [[(0.3, 1.0)], [(0.3, 1.0)]]))],
        "gendir": [(dq.GeneralizedDirichlet(
            depvar="y", b=(0.1, 1.5, 0.8), S=(0.3, 0.45, 0.1),
            kappa=(0.1, 0.3, 0.2), cij=(0.1, -0.2, 0.3)),
            ("jointdelta", [[(0.2, 0.5), (0.3, 0.5)], [(0.3, 1.0)],
                            [(0.1, 0.4), (0.2, 0.6)]]))],
        "gamma": [(dq.Gamma(depvar="y", b=(1.5,), S=(0.6,), kappa=(0.5,)),
                   ("jointgamma", [(2.0, 0.5)]))],
        "skew_normal": [(dq.SkewNormal(depvar="y", T=(1.0, 2.0),
                                       sigmasq=(0.04, 0.1), lam=(2.0, -1.0)),
                         ("jointgaussian", [(0.0, 0.04), (0.1, 0.1)]))],
        "wright_fisher": [(dq.WrightFisher(depvar="y",
                                           omega=(0.25, 0.5, 0.25)),
                           ("jointdelta", [[(0.2, 0.5), (0.3, 0.5)],
                                           [(0.25, 1.0)],
                                           [(0.3, 0.5), (0.2, 0.5)]]))],
    }
    for coeff in ("decay", "homdecay", "montecarlo_homdecay"):
        out[f"mixmassfracbeta_{coeff}"] = [(dq.MixMassFractionBeta(
            depvar="x", bprime=(2.0, 1.0), S=(0.5, 0.4), kprime=(0.5, 0.3),
            rho2=(1.0, 2.0), r=(0.5, 0.3), coeff=coeff),
            ("jointbeta", _BETA + [(2.0, 4.0, 0.0, 1.0)]))]
    out["mixmassfracbeta_hydrotimescale"] = [(dq.MixMassFractionBeta(
        depvar="x", bprime=(2.0,), S=(0.5, 0.4, 0.3), kprime=(0.5,),
        rho2=(1.0,), r=(0.5,), coeff="hydrotimescale",
        hts=(hts("A05S"),), hp=(hp("A05S"),)),
        ("jointbeta", [(2.0, 2.0, 0.1, 0.8)]))]
    for coeff, norm in (("const_coeff", "light"), ("homogeneous", "light"),
                        ("homogeneous", "heavy")):
        rho = (1.0, 2.0, 3.0) if norm == "heavy" else (3.0, 2.0, 1.0)
        out[f"mixdirichlet_{coeff}_{norm}"] = [(dq.MixDirichlet(
            depvar="y", b=(1.0, 1.5), S=(0.4, 0.3), kprime=(0.5, 0.7),
            rho=rho, coeff=coeff, normalization=norm),
            ("jointdirichlet", [2.0, 3.0, 4.0]))]
    for name, vkw in (("langevin_slm", {}),
                      ("langevin_glm", {"variant": "glm",
                                        "dU": (0.0, 1.0) + (0.0,) * 7}),
                      ("langevin_stationary", {"coeff": "stationary"}),
                      ("langevin_hydrotimescale",
                       {"coeff": "hydrotimescale", "hts": hts("A075H")})):
        pos = dq.Position(depvar="x", dU=(0.0, 1.0) + (0.0,) * 7)
        vel = dq.Velocity(depvar="u", c0=2.1, **vkw)
        dis = dq.Dissipation(depvar="o", c3=1.0, c4=0.25)
        out[name] = [(pos, ("jointgaussian", [(0.0, 1.0)] * 3)),
                     (vel, ("jointgaussian", [(0.0, 0.5), (0.1, 0.4),
                                              (0.0, 0.3)])),
                     (dis, ("jointgaussian", [(1.0, 0.01)]))]
    return out


CASES = sorted(_systems(jdq, jhydro))
#: cases that start at t0 = 1: their tables are sampled inside their range
T0 = {"mixmassfracbeta_hydrotimescale": 1.0, "langevin_hydrotimescale": 1.0}


def _walker(pkg, name, npar=NPAR, seed=SEED):
    """The case's walker in pkg ('jax' or 'port'), couplings wired."""
    if pkg == "jax":
        dq, ip, hydro = jdq, jip, jhydro
    else:
        dq, ip, hydro = tdq, tip, thydro
    pairs = _systems(dq, hydro)[name]
    systems = [s for s, _ in pairs]
    for s, (policy, args) in pairs:
        fn = getattr(ip, f"init_{policy}")
        if policy == "jointcorrgaussian":
            s.init = (lambda k, n, fn=fn, a=args, **kw: fn(k, n, *a, **kw))
        else:
            s.init = (lambda k, n, fn=fn, a=args, **kw: fn(k, n, a, **kw))
    Walker_ = JWalker if pkg == "jax" else Walker
    systems = Walker_.layout(systems)
    by = {s.depvar: s for s in systems}
    if "u" in by:
        by["x"].velocity_offset = by["u"].offset
        by["u"].dissipation_offset = by["o"].offset
        by["o"].velocity_offset = by["u"].offset
    kw = {} if pkg == "jax" else {"device": "cpu"}
    return Walker_(systems, npar=npar, dt=DT, t0=T0.get(name, 0.0),
                   seed=seed, **kw)


def _terms(w):
    """Moment requests over every advanced slot: means, variances and a
    cross product per system."""
    ordinary, central = [], []
    for s in w.systems:
        n = s.ncomp
        for c in range(n):
            ordinary.append(((s.depvar, c),))
            central.append(((s.depvar, c), (s.depvar, c)))
        ordinary.append(tuple((s.depvar, c) for c in range(n)))
        if n > 1:
            central.append(((s.depvar, 0), (s.depvar, 1), (s.depvar, 1)))
    return ordinary, central


@pytest.fixture(scope="module")
def f64_module():
    prev = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    try:
        yield
    finally:
        torch.set_default_dtype(prev)


@pytest.fixture(scope="module")
def runs(f64_module):
    """Per case: (P0, P1, P10) of the JAX walker and of the port's, both
    walkers, and each run's moment history over 10 steps (stat_every 5,
    in two run() calls of 1 and 9 steps)."""
    out = {}
    for name in CASES:
        res = {}
        for pkg in ("jax", "port"):
            w = _walker(pkg, name)
            w.ordinary, w.central = _terms(w)
            P0 = w.initialize()
            P1, h1 = w.run(1, stat_every=5, P=P0)
            P10, h2 = w.run(9, stat_every=5, P=P1)
            res[pkg] = ([np.asarray(P0), np.asarray(P1), np.asarray(P10)],
                        w, h1 + h2)
        out[name] = res
    return out


@pytest.mark.parametrize("name", CASES)
def test_initial_ensemble_and_one_step(runs, name):
    (jP, _, _), (tP, _, _) = runs[name]["jax"], runs[name]["port"]
    for a, b in zip(tP[:2], jP[:2]):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=STEP_RTOL, atol=STEP_ATOL)
    assert not np.array_equal(jP[1], jP[0])


@pytest.mark.parametrize("name", CASES)
def test_ten_steps(runs, name):
    (jP, _, _), (tP, _, _) = runs[name]["jax"], runs[name]["port"]
    assert np.isfinite(tP[2]).all()
    np.testing.assert_allclose(tP[2], jP[2], rtol=RUN_RTOL, atol=RUN_ATOL)


@pytest.mark.parametrize("name", CASES)
def test_moments_of_one_array_and_run_history(runs, name):
    (jP, jw, jh), (tP, tw, th) = runs[name]["jax"], runs[name]["port"]
    assert tw.offsets == jw.offsets and tw.nprop == jw.nprop
    want = {k: float(v) for k, v in j_moments(
        jP[2], jw.offsets, jw.ordinary, jw.central).items()}
    got = moments_to_host(estimate_moments(torch.from_numpy(jP[2].copy()),
                                           tw.offsets, tw.ordinary,
                                           tw.central))
    assert list(got) == list(want)
    assert any(k[0] == "C" for k in got)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=MOM_RTOL,
                                   atol=1e-15, err_msg=str(k))
    # the runs' histories: steps 5 and 10, after run(1) and run(9)
    assert [t for t, _ in th] == pytest.approx([t for t, _ in jh],
                                               rel=1e-14)
    assert len(th) == 2
    for (_, a), (_, b) in zip(th, jh):
        for k in b:
            np.testing.assert_allclose(a[k], b[k], rtol=RUN_RTOL,
                                       atol=1e-13, err_msg=str(k))


@pytest.mark.parametrize("name", CASES)
def test_run_across_calls_continues_the_counter(runs, name):
    """10 steps in one call equal run(1) + run(9), bit for bit."""
    (_, _, _), (tP, tw, _) = runs[name]["jax"], runs[name]["port"]
    assert tw._it0 == 10
    w = _walker("port", name)
    P, _ = w.run(10)
    np.testing.assert_array_equal(P.numpy(), tP[2])


def _pdf_cases(w):
    """(term, binsizes, extents, central) of 1-, 2- and 3-D PDFs of the
    walker's first system, with data extents and given ones."""
    s = w.systems[0]
    v = [(s.depvar, c % s.ncomp) for c in range(3)]
    return [((v[0],), [0.05], None, None),
            ((v[0],), [0.1], [(-0.5, 0.5)], (True,)),
            ((v[0], v[1]), [0.1, 0.05], None, (False, True)),
            ((v[0], v[1], v[2]), [0.2, 0.2, 0.1], None, None),
            ((v[0], v[1], v[2]), [0.25, 0.2, 0.2], [(-1, 1)] * 3,
             (True, False, True))]


@pytest.mark.parametrize("name", CASES)
def test_pdfs_of_one_array_identical(runs, name):
    (jP, jw, _), (_, tw, _) = runs[name]["jax"], runs[name]["port"]
    for term, bins, ext, cen in _pdf_cases(tw):
        want = j_pdf(jP[2], jw.offsets, term, bins, ext, central=cen)
        got = estimate_pdf(torch.from_numpy(jP[2]), tw.offsets, term, bins,
                           ext, central=cen)
        assert type(got).__name__ == type(want).__name__
        assert got.lo == want.lo and got.binsize == want.binsize
        assert got.counts.dtype == np.asarray(want.counts).dtype
        np.testing.assert_array_equal(got.counts, np.asarray(want.counts))
        assert got.counts.sum() == NPAR
    assert tw.pdf(torch.from_numpy(jP[2]), *_pdf_cases(tw)[0]).nsamples \
        == NPAR


INIT_POLICIES = {
    "zero": (lambda ip: ip.init_zero, (3,)),
    "raw": (lambda ip: ip.init_raw, (2,)),
    "jointdelta": (lambda ip: ip.init_jointdelta,
                   ([[(0.1, 0.2), (0.5, 0.3), (0.9, 0.5)], [(2.0, 1.0)]],)),
    "jointbeta": (lambda ip: ip.init_jointbeta,
                  ([(0.3, 2.5, 0.0, 1.0), (2.0, 2.0, -1.0, 2.0)],)),
    "jointgaussian": (lambda ip: ip.init_jointgaussian,
                      ([(0.0, 1.0), (1.5, 0.25), (-2.0, 4.0)],)),
    "jointcorrgaussian": (lambda ip: ip.init_jointcorrgaussian,
                          ([0.0, 1.0], [[1.0, 0.3], [0.3, 0.5]])),
    "jointgamma": (lambda ip: ip.init_jointgamma,
                   ([(0.3, 1.0), (2.5, 0.5), (10.0, 2.0)],)),
    "jointdirichlet": (lambda ip: ip.init_jointdirichlet,
                       ([0.3, 1.0, 2.5, 10.0],)),
}


@pytest.mark.parametrize("name", sorted(INIT_POLICIES))
def test_init_policy_matches_jax(f64_module, name):
    import jax

    get, args = INIT_POLICIES[name]
    want = np.asarray(get(jip)(jax.random.fold_in(jax.random.key(9), 10_003),
                               2048, *args))
    from quinoa_tpu_torch.rng import threefry as tf

    got = get(tip)(tf.fold_in(tf.key(9), 10_003), 2048, *args,
                   device="cpu").numpy()
    assert got.shape == want.shape and got.dtype == np.float64
    np.testing.assert_allclose(got, want, rtol=STEP_RTOL, atol=STEP_ATOL)
    if name == "jointdirichlet":
        np.testing.assert_allclose(got.sum(axis=1), 1.0, rtol=1e-14)


@pytest.mark.parametrize("name", sorted(INIT_POLICIES))
def test_init_policy_draws_on_the_card_by_default(name):
    """Without device=, a policy builds on the card: with no card it
    raises instead of building on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default builds there")
    from quinoa_tpu_torch.rng import threefry as tf

    get, args = INIT_POLICIES[name]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        get(tip)(tf.key(0), 4, *args)


def test_spike_probabilities_must_sum_to_one():
    from quinoa_tpu_torch.rng import threefry as tf

    with pytest.raises(ValueError, match="sum to 1"):
        tip.init_jointdelta(tf.key(0), 10, [[(0.0, 0.5), (1.0, 0.4)]],
                            device="cpu")


def test_wright_fisher_on_the_simplex(f64_module):
    """Components summing to 1: one step to WF_SIMPLEX_ATOL (see the
    module docstring), the sum still 1 to round-off in both."""
    spikes = [[(0.3, 1.0)], [(0.4, 1.0)], [(0.3, 1.0)]]
    out = []
    for dq, W, kw in ((jdq, JWalker, {}), (tdq, Walker, {"device": "cpu"})):
        s = dq.WrightFisher(depvar="y", omega=(0.25, 0.5, 0.25))
        s.init = lambda k, n, dq=dq, **k2: dq.init_jointdelta(k, n, spikes,
                                                              **k2)
        w = W(W.layout([s]), npar=NPAR, dt=0.005, seed=7, **kw)
        out.append(np.asarray(w.run(1)[0]))
    np.testing.assert_allclose(out[1], out[0], rtol=0, atol=WF_SIMPLEX_ATOL)
    for P in out:
        np.testing.assert_allclose(P.sum(axis=1), 1.0, atol=1e-12)


@pytest.mark.parametrize("name", ["langevin_slm", "mixdirichlet_homogeneous"
                                  "_light", "gendir"])
def test_state_carried_across_mid_run(f64_module, name):
    """Three JAX steps, then the JAX walker's P, key data and step counter
    into a fresh port walker (convert.walker_state_from_arrays): the next
    four steps match the JAX walker's."""
    import jax

    jw = _walker("jax", name, seed=13)
    jP, _ = jw.run(3)
    tw = _walker("port", name, seed=0)
    P = convert.walker_state_from_arrays(
        tw, np.asarray(jP), np.asarray(jax.random.key_data(jw.key)),
        jw._it0)
    assert P.dtype == torch.float64 and tw._it0 == 3
    jP, _ = jw.run(4, P=jP)
    tP, _ = tw.run(4, P=P)
    np.testing.assert_allclose(tP.numpy(), np.asarray(jP), rtol=RUN_RTOL,
                               atol=RUN_ATOL)
    with pytest.raises(ValueError, match="does not fit"):
        convert.walker_state_from_arrays(tw, np.zeros((3, 2)), (0, 1), 0)
    with pytest.raises(ValueError, match="two 32-bit words"):
        convert.walker_state_from_arrays(tw, np.asarray(jP), (1, 2, 3), 0)


def test_table_is_jnp_interp():
    import jax.numpy as jnp

    from quinoa_tpu.base.table import Table as JTable

    x, y = np.array([0.5, 1.0, 2.5, 4.0]), np.array([1.0, -2.0, 0.3, 7.0])
    t, j = Table(x, y), JTable(x, y)
    for s in (0.0, 0.5, 0.7, 1.0, 1.3, 2.5, 3.99, 4.0, 9.0):
        assert t(s) == pytest.approx(float(j(jnp.asarray(s))), rel=1e-15)
    tables = (thydro.hydro_table("eq_A05S"), jhydro.hydro_table("eq_A05S"))
    np.testing.assert_array_equal(tables[0].x, np.asarray(tables[1].x))
    np.testing.assert_array_equal(tables[0].y, np.asarray(tables[1].y))
    with pytest.raises(KeyError, match="unknown hydro table"):
        thydro.hydro_table("nope")
    with pytest.raises(ValueError):
        Table([1.0, 0.5], [0.0, 1.0])


@pytest.fixture(scope="module")
def pdfs(runs):
    """1-, 2- and 3-D PDFs of one particle array (the coupled Langevin
    family after 10 steps), from the port's estimator."""
    P, w = runs["langevin_slm"]["port"][0][2], runs["langevin_slm"]["port"][1]
    return {len(term): w.pdf(torch.from_numpy(P), term, bins, ext, cen)
            for term, bins, ext, cen in _pdf_cases(w)[2:4]
            + _pdf_cases(w)[:1]}


@pytest.mark.parametrize("what", ["txt1", "txt2", "txt3", "txt_fixed",
                                  "gmsh_elem", "gmsh_node", "exo1", "exo2",
                                  "exo3"])
def test_pdf_writers_write_the_jax_files(pdfs, tmp_path, what):
    nd = int(what[-1]) if what[-1].isdigit() else 2
    pdf = pdfs[nd]
    if what.startswith("txt"):
        kw = {"fmt": "fixed", "precision": 6} if what == "txt_fixed" else {}
        pair = (lambda p, x: j_txt(p, x, **kw),
                lambda p, x: write_pdf_txt(p, x, **kw))
    elif what.startswith("gmsh"):
        cen = what.split("_")[1]
        pair = (lambda p, x: j_gmsh(p, x, centering=cen),
                lambda p, x: write_pdf_gmsh(p, x, centering=cen))
    else:
        pair = (j_exo, write_pdf_exodus)
    a, b = str(tmp_path / "jax.out"), str(tmp_path / "port.out")
    pair[0](a, pdf)
    pair[1](b, pdf)
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()


@pytest.mark.parametrize("fmt", ["scientific", "fixed", "default"])
def test_stat_writer_writes_the_jax_rows(tmp_path, fmt):
    ordinary = [(("y", 0),), (("y", 0), ("u", 2))]
    central = [(("y", 1), ("y", 1))]
    mom = {ordinary[0]: 0.125, ordinary[1]: -3.5e-7,
           ("C",) + central[0]: 2.0 / 3.0}
    paths = []
    for W in (JTxtStatWriter, TxtStatWriter):
        p = str(tmp_path / f"{W.__module__.split('.')[0]}.txt")
        w = W(p, ordinary, central, fmt=fmt, precision=7)
        w.write(3, 0.03, mom)
        w.write(6, 0.06, mom)
        w.close()
        paths.append(p)
    with open(paths[0]) as fa, open(paths[1]) as fb:
        assert fa.read() == fb.read()


def test_systems_mirror_the_jax_fields():
    """Every system class has the JAX class's fields and defaults, and
    the same nprop at the defaults."""
    names = [n for n in jdq.__all__ if not n.startswith("init_")]
    assert names == [n for n in tdq.__all__ if not n.startswith("init_")]
    for n in names:
        jf = {f.name: f.default for f in dataclasses.fields(getattr(jdq, n))}
        tf_ = {f.name: f.default
               for f in dataclasses.fields(getattr(tdq, n))}
        assert tf_ == jf, n
        assert getattr(tdq, n)().nprop == getattr(jdq, n)().nprop
