"""Control-file keyword metadata and the generated help (-H).

The port's own copy of quinoa_tpu/control/keywords.py, the counterpart of
the reference's HelpFactory machinery (src/Control/HelpFactory.hpp;
src/Base/Keyword.hpp:90-99): every deck keyword carries a short and a
long description, `-H` prints the keyword list and `-H <keyword>` that
keyword's page.  The registry is a plain dict over the deck surface
control/qparser.py parses and control/config.py consumes, one entry per
keyword with (kind, parents, usage, short, long); the text is the JAX
package's, character for character.
"""

from __future__ import annotations

from typing import Dict, Optional

#: keyword -> dict(kind, parent, usage, short, long)
#: kind: 'block' | 'scalar' | 'list' | 'string'
KEYWORDS: Dict[str, dict] = {
    # -- root ------------------------------------------------------------
    "title": dict(
        kind="string", parent="<root>", usage='title "..."',
        short="Set analysis title",
        long="Quoted title string echoed in output headers."),
    "inciter": dict(
        kind="block", parent="<root>", usage="inciter ... end",
        short="Start the inciter (PDE solver) input block",
        long="Block selecting and configuring the partial differential "
             "equation solver: time stepping, scheme, PDE system, "
             "boundary conditions, AMR, output."),
    "walker": dict(
        kind="block", parent="<root>", usage="walker ... end",
        short="Start the walker (SDE particle) input block",
        long="Block configuring stochastic differential equation "
             "integration over particle ensembles: npar, dt, SDE "
             "systems, statistics, PDFs."),
    "rngtest": dict(
        kind="block", parent="<root>", usage="rngtest ... end",
        short="Start the random-number generator test suite block",
        long="Block selecting a statistical battery (smallcrush, "
             "crush, bigcrush) and the RNGs to subject to it."),
    # -- inciter time stepping ------------------------------------------
    "nstep": dict(
        kind="scalar", parent="inciter", usage="nstep <int>",
        short="Set number of time steps to take",
        long="Maximum number of time steps; stepping stops at nstep or "
             "term, whichever comes first."),
    "term": dict(
        kind="scalar", parent="inciter", usage="term <real>",
        short="Set maximum physical time to simulate",
        long="Terminate time stepping when physical time reaches this "
             "value."),
    "t0": dict(
        kind="scalar", parent="inciter", usage="t0 <real>",
        short="Set starting non-dimensional time",
        long="Initial physical time (default 0)."),
    "dt": dict(
        kind="scalar", parent="inciter", usage="dt <real>",
        short="Select constant time step size",
        long="Constant dt; mutually exclusive with cfl (if both are "
             "given, the constant dt wins, matching the reference's "
             "precedence)."),
    "cfl": dict(
        kind="scalar", parent="inciter", usage="cfl <real>",
        short="Set CFL coefficient for adaptive dt",
        long="Courant-Friedrichs-Lewy coefficient scaling the minimum "
             "characteristic element time scale each step."),
    "ttyi": dict(
        kind="scalar", parent="inciter", usage="ttyi <int>",
        short="Set screen output interval",
        long="One-liner progress row is printed every ttyi steps."),
    "scheme": dict(
        kind="scalar", parent="inciter",
        usage="scheme diagcg|alecg|dg|p0p1|dgp1|dgp2|pdg",
        short="Select discretization scheme",
        long="diagcg: node-centered lumped-mass Taylor-Galerkin + FCT; "
             "alecg: node-centered edge-based RK3; dg/p0p1/dgp1/dgp2: "
             "cell-centered discontinuous Galerkin of increasing order; "
             "pdg: p-adaptive DG."),
    "limiter": dict(
        kind="scalar", parent="inciter",
        usage="limiter nolimiter|wenop1|superbeep1",
        short="Select DG slope limiter",
        long="Limiter applied to DG(P1) degrees of freedom each RK "
             "stage: none, WENO reconstruction, or Superbee."),
    "cweight": dict(
        kind="scalar", parent="inciter", usage="cweight <real>",
        short="Set WENO central-stencil weight",
        long="Central linear weight for the WENO limiter (1..1000)."),
    "pelocal_reorder": dict(
        kind="scalar", parent="inciter", usage="pelocal_reorder true",
        short="Toggle the locality node reordering",
        long="The tpu port always applies its Hilbert + first-touch "
             "locality reorder (the Sorter analog); the keyword is "
             "accepted for deck compatibility."),
    # -- pde blocks ------------------------------------------------------
    "transport": dict(
        kind="block", parent="inciter", usage="transport ... end",
        short="Start the scalar transport PDE block",
        long="Advection(-diffusion) of ncomp scalars with a prescribed "
             "velocity field; problem selects the benchmark policy."),
    "compflow": dict(
        kind="block", parent="inciter", usage="compflow ... end",
        short="Start the compressible flow (Euler) PDE block",
        long="Single-material compressible Euler equations; material "
             "sets the equation of state, problem the benchmark."),
    "multimat": dict(
        kind="block", parent="inciter", usage="multimat ... end",
        short="Start the multi-material flow PDE block",
        long="nmat-material compressible flow with volume fractions "
             "(scheme dg = P0, the reference fork's parity surface — "
             "it asserts ndof==1; scheme dgp1 adds consistent-limited "
             "DG(P1) with optional THINC sharpening, beyond-parity)."),
    "physics": dict(
        kind="scalar", parent="transport|compflow|multimat",
        usage="physics advection|advdiff|euler|veleq",
        short="Select physics configuration",
        long="Physics policy inside a PDE block (advection/advdiff for "
             "transport, euler for compflow, veleq for multimat)."),
    "problem": dict(
        kind="scalar", parent="transport|compflow|multimat",
        usage="problem <name>",
        short="Select problem (initial/boundary condition policy)",
        long="Benchmark policy: slot_cyl, gauss_hump, cyl_advect, "
             "shear_diff, user_defined (transport); sedov_blastwave, "
             "sod_shocktube, taylor_green, vortical_flow, "
             "rayleigh_taylor, nl_energy_growth, rotated_sod_shocktube "
             "(compflow); interface_advection, sod_shocktube, "
             "smooth_wave (multimat)."),
    "ncomp": dict(
        kind="scalar", parent="transport", usage="ncomp <int>",
        short="Set number of scalar components",
        long="Number of transported scalar fields."),
    "depvar": dict(
        kind="scalar", parent="*pde*|*sde*", usage="depvar <char>",
        short="Select dependent variable name",
        long="Single character naming the solution variable in output "
             "and statistics (e.g. c: <c> <cc>)."),
    "nmat": dict(
        kind="scalar", parent="multimat", usage="nmat <int>",
        short="Set number of materials",
        long="Material count for the multi-material system."),
    "intsharp": dict(
        kind="scalar", parent="multimat", usage="intsharp 0|1",
        short="Toggle THINC interface sharpening (dgp1 multimat)",
        long="Algebraic tanh interface reconstruction of the volume "
             "fractions at face quadrature points (upstream Quinoa's "
             "keyword; requires scheme dgp1)."),
    "intsharp_param": dict(
        kind="scalar", parent="multimat", usage="intsharp_param <real>",
        short="THINC interface steepness beta",
        long="Steepness of the tanh profile; default 2.5 (measured "
             "best against the consistent-Superbee baseline: 48 vs 80 "
             "interface cells after 10 cells of planar advection)."),
    "material": dict(
        kind="block", parent="compflow|multimat",
        usage="material gamma ... end [cv ... end] [pstiff ... end] end",
        short="Start a material (equation of state) block",
        long="Stiffened-gas EoS parameters: ratio of specific heats "
             "gamma, specific heat cv, stiffness pstiff — one value "
             "per material."),
    "gamma": dict(
        kind="list", parent="material", usage="gamma <real>... end",
        short="Set material ratio(s) of specific heats",
        long="Heat capacity ratio per material (also: a walker SDE "
             "block name under walker)."),
    "cv": dict(
        kind="list", parent="material", usage="cv <real>... end",
        short="Set material specific heat(s)",
        long="Specific heat at constant volume per material."),
    "pstiff": dict(
        kind="list", parent="material", usage="pstiff <real>... end",
        short="Set material stiffness parameter(s)",
        long="Stiffened-gas pressure stiffness per material."),
    "flux": dict(
        kind="scalar", parent="compflow|multimat",
        usage="flux hllc|laxfriedrichs|ausm|upwind",
        short="Select Riemann flux function",
        long="Numerical flux for DG face integrals: HLLC, "
             "Lax-Friedrichs, AUSM+up (multimat), Upwind (transport)."),
    "diffusivity": dict(
        kind="list", parent="transport", usage="diffusivity <real>... end",
        short="Set scalar diffusivities",
        long="3 x ncomp diffusion coefficients for advdiff physics."),
    "u0": dict(
        kind="list", parent="transport", usage="u0 <real>... end",
        short="Set shear-velocity parameters",
        long="Problem-policy velocity parameters (shear_diff)."),
    "lambda": dict(
        kind="list", parent="transport", usage="lambda <real>... end",
        short="Set shear-rate parameters",
        long="Problem-policy shear rates (shear_diff)."),
    # -- boundary conditions --------------------------------------------
    "bc_dirichlet": dict(
        kind="block", parent="*pde*",
        usage="bc_dirichlet sideset <int>... end end",
        short="Start a Dirichlet boundary condition block",
        long="Pin the analytic solution on the listed side sets "
             "(DiagCG::solve pins lhs=1, rhs=increment there)."),
    "bc_sym": dict(
        kind="block", parent="*pde*",
        usage="bc_sym sideset <int>... end end",
        short="Start a symmetry boundary condition block",
        long="Reflect the normal velocity component on the listed side "
             "sets."),
    "bc_extrapolate": dict(
        kind="block", parent="*pde*",
        usage="bc_extrapolate sideset <int>... end end",
        short="Start an extrapolation boundary condition block",
        long="Zero-gradient (outflow) condition on the listed side "
             "sets."),
    "bc_inlet": dict(
        kind="block", parent="*pde*",
        usage="bc_inlet sideset <int>... end end",
        short="Start an inlet boundary condition block",
        long="Prescribed inflow state on the listed side sets."),
    "bc_outlet": dict(
        kind="block", parent="*pde*",
        usage="bc_outlet sideset <int>... end end",
        short="Start an outlet boundary condition block",
        long="Outflow condition on the listed side sets."),
    "sideset": dict(
        kind="list", parent="bc_*|amr",
        usage="sideset <int>... end",
        short="Select side set ids",
        long="Exodus side-set ids a boundary condition (or coordinate-"
             "based refinement) applies to."),
    # -- partitioning / parallel ----------------------------------------
    "partitioning": dict(
        kind="block", parent="inciter", usage="partitioning ... end",
        short="Start the mesh partitioning block",
        long="Selects the domain-decomposition algorithm for --npes "
             "runs."),
    "algorithm": dict(
        kind="scalar", parent="partitioning",
        usage="algorithm sfc|hsfc|rcb|rib|mj|phg",
        short="Select partitioning algorithm",
        long="sfc/hsfc: Hilbert space-filling curve; rcb: recursive "
             "coordinate bisection; rib: recursive inertial bisection; "
             "mj: multi-jagged; phg: hypergraph (connectivity-aware "
             "KL refinement analog)."),
    # -- amr -------------------------------------------------------------
    "amr": dict(
        kind="block", parent="inciter", usage="amr ... end",
        short="Start the adaptive mesh refinement block",
        long="Initial (t0ref) and during-timestep (dtref) tetrahedral "
             "AMR: error-driven tagging, 1:8/1:4/1:2 subdivision, "
             "compatibility closure, derefinement."),
    "coordref": dict(
        kind="block", parent="amr", usage="coordref x- 0.5 ... end",
        short="Half-world extents for `initial coords` refinement",
        long="Edges are tagged unless both endpoints lie strictly "
             "outside every configured halfspace (x-/x+/y-/y+/z-/z+; "
             "Refiner::coordRefine)."),
    "t0ref": dict(
        kind="scalar", parent="amr", usage="t0ref true|false",
        short="Enable initial-mesh refinement",
        long="Apply the `initial` refinement directives before time "
             "stepping."),
    "dtref": dict(
        kind="scalar", parent="amr", usage="dtref true|false",
        short="Enable during-timestep refinement",
        long="Re-adapt the mesh every dtfreq steps from the solution "
             "error indicator; under --npes every remesh is a "
             "resharding event."),
    "dtref_uniform": dict(
        kind="scalar", parent="amr", usage="dtref_uniform true|false",
        short="Enable uniform during-timestep refinement",
        long="Uniformly refine (instead of error-tagging) at every "
             "dtref cycle."),
    "dtfreq": dict(
        kind="scalar", parent="amr", usage="dtfreq <int>",
        short="Set mesh refinement frequency",
        long="Re-adapt the mesh every dtfreq time steps when dtref is "
             "on."),
    "initial": dict(
        kind="scalar", parent="amr",
        usage="initial uniform|uniform_derefine|ic|coords|edgelist",
        short="Select initial-refinement directive (repeatable)",
        long="uniform: refine every tet; uniform_derefine: coarsen "
             "uniformly; ic: tag from the initial condition error; "
             "coords: tag edges inside the x/y/z +/- half-spaces; "
             "edgelist: tag the listed node-pair edges."),
    "edgelist": dict(
        kind="list", parent="amr", usage="edgelist <int int>... end",
        short="Set edges to refine (node-id pairs)",
        long="Flat list of node-id pairs; each pair's edge is tagged "
             "for the edgelist t0ref directive."),
    "coords": dict(
        kind="block", parent="amr",
        usage="coords [xminus <real>] [xplus <real>] ... end",
        short="Start the coordinate-based refinement block",
        long="Half-space bounds (xminus/xplus/yminus/yplus/zminus/"
             "zplus) selecting the region whose edges the coords "
             "t0ref directive refines."),
    "error": dict(
        kind="scalar", parent="amr|diagnostics",
        usage="error jump|hessian  (amr) / error l2|linf (diagnostics)",
        short="Select error indicator / diagnostics norm",
        long="In amr: the dtref tagging estimator. In diagnostics: "
             "which norms of the numerical-minus-analytic error to "
             "write."),
    "tolref": dict(
        kind="scalar", parent="amr|pref", usage="tolref <real>",
        short="Set refinement tolerance",
        long="Edges with indicator above this refine (amr); elements "
             "with gradient indicator above this keep P1 (pref)."),
    "tolderef": dict(
        kind="scalar", parent="amr", usage="tolderef <real>",
        short="Set derefinement tolerance",
        long="Edges with indicator below this coarsen."),
    "maxlevels": dict(
        kind="scalar", parent="amr", usage="maxlevels <int>",
        short="Set maximum refinement level",
        long="Cap on per-element refinement depth.  Default 4 = the "
             "reference's hard-coded MAX_REFINEMENT_LEVEL "
             "(refinement.hpp:28); 1 opts out to single-level "
             "retag-from-base dtref (extension)."),
    "refvar": dict(
        kind="list", parent="amr", usage="refvar <char>... end",
        short="Select refinement variable(s)",
        long="Dependent variables the error estimator watches."),
    # -- pref ------------------------------------------------------------
    "pref": dict(
        kind="block", parent="inciter", usage="pref ... end",
        short="Start the p-adaptive refinement block",
        long="Configures p-adaptation for scheme pdg: indicator and "
             "tolref threshold."),
    "indicator": dict(
        kind="scalar", parent="pref", usage="indicator pref_spectral_decay",
        short="Select p-refinement indicator",
        long="Indicator function deciding which elements evolve P1 vs "
             "P0 dofs."),
    "ndofmax": dict(
        kind="scalar", parent="pref", usage="ndofmax 4|10",
        short="Set maximum p-adaptive dof count",
        long="Upper bound on per-element degrees of freedom."),
    # -- output ----------------------------------------------------------
    "diagnostics": dict(
        kind="block", parent="inciter",
        usage="diagnostics interval <int> error l2 ... end",
        short="Start the diagnostics output block",
        long="L2/Linf solution and error norms appended to the diag "
             "file every `interval` steps; format/precision control "
             "the text encoding."),
    "field_output": dict(
        kind="block", parent="inciter",
        usage="field_output interval <int> end",
        short="Start the field output block",
        long="Exodus field writes every `interval` steps (one file, or "
             "per-piece files under --pieces)."),
    "interval": dict(
        kind="scalar", parent="diagnostics|field_output",
        usage="interval <int>",
        short="Set output interval in steps",
        long="Write every N steps."),
    "format": dict(
        kind="scalar", parent="diagnostics|pdfs",
        usage="format default|scientific|txt|gmshtxt|gmshbin|exodusii",
        short="Select output text/file format",
        long="Float formatting for diag files; file format for PDF "
             "output."),
    "precision": dict(
        kind="scalar", parent="diagnostics|pdfs", usage="precision <int>",
        short="Set output precision in digits",
        long="Stream precision of text output (max: machine digits10)."),
    "plotvar": dict(
        kind="block", parent="inciter", usage="plotvar ... end",
        short="Start the plot-variable selection block",
        long="Selects which fields the field output writes."),
    "filetype": dict(
        kind="scalar", parent="field_output", usage="filetype exodusii",
        short="Select field output file type",
        long="ExodusII is the supported field format (classic and "
             "netcdf-4/HDF5)."),
    # -- walker ----------------------------------------------------------
    "npar": dict(
        kind="scalar", parent="walker", usage="npar <int>",
        short="Set number of particles",
        long="Ensemble size for SDE integration."),
    "rngs": dict(
        kind="block", parent="walker|rngtest", usage="rngs ... end",
        short="Start the random-number generators block",
        long="Selects RNG streams (r123_threefry, r123_philox) and "
             "their seeds."),
    "r123_threefry": dict(
        kind="block", parent="rngs", usage="r123_threefry [seed <int>] end",
        short="Select the Random123 ThreeFry RNG",
        long="Counter-based ThreeFry generator (jax threefry2x32 "
             "stream)."),
    "r123_philox": dict(
        kind="block", parent="rngs", usage="r123_philox [seed <int>] end",
        short="Select the Random123 Philox RNG",
        long="Counter-based Philox generator (jax rbg stream)."),
    "seed": dict(
        kind="scalar", parent="r123_*", usage="seed <int>",
        short="Set RNG seed",
        long="Seed of the enclosing generator block."),
    "statistics": dict(
        kind="block", parent="walker", usage="statistics <Y1Y2>... end",
        short="Start the statistics estimation block",
        long="Products of central (<yy>) / ordinary (<YY>) moments to "
             "estimate over the ensemble each step."),
    "pdfs": dict(
        kind="block", parent="walker",
        usage="pdfs interval <int> filetype txt f(Y:dy)... end",
        short="Start the PDF estimation block",
        long="Uni/bi/trivariate probability density estimators with "
             "sample-space binning f(y1,y2:dy1,dy2), written every "
             "interval steps."),
    "init": dict(
        kind="scalar", parent="*sde*",
        usage="init raw|zero|delta|beta|gaussian|jointgaussian|gamma|dirichlet",
        short="Select particle initialization policy",
        long="How the ensemble is initialized: raw (leave memory), "
             "zero, or sampled from delta spikes / beta / gaussian / "
             "joint gaussian / gamma / dirichlet parameter blocks."),
    "coeff": dict(
        kind="scalar", parent="*sde*",
        usage="coeff const_coeff|decay|homdecay|montecarlo_homdecay|hydrotimescale",
        short="Select SDE coefficients policy",
        long="Constant coefficients or the decay/homogeneous-decay/"
             "Monte-Carlo-homdecay/hydro-timescale closures (beta "
             "family)."),
    "solve": dict(
        kind="scalar", parent="*sde*",
        usage="solve fullvar|fluctuation",
        short="Select dependent-variable form to solve for",
        long="Integrate the full variable or its fluctuation "
             "(velocity/position models)."),
    # -- rngtest ---------------------------------------------------------
    "smallcrush": dict(
        kind="block", parent="rngtest", usage="smallcrush end",
        short="Select the SmallCrush battery",
        long="14-test battery (TestU01 SmallCrush analog) with exact "
             "p-value laws."),
    "crush": dict(
        kind="block", parent="rngtest", usage="crush end",
        short="Select the Crush battery",
        long="23-family battery (TestU01 Crush analog)."),
    "bigcrush": dict(
        kind="block", parent="rngtest", usage="bigcrush end",
        short="Select the BigCrush battery",
        long="48-instance battery (TestU01 BigCrush analog)."),
    # -- walker SDE system blocks ---------------------------------------
    "diag_ou": dict(
        kind="block", parent="walker", usage="diag_ou ... end",
        short="Start the diagonal Ornstein-Uhlenbeck SDE block",
        long="OU process with diagonal diffusion: sigmasq, theta, mu "
             "coefficient vectors; depvar, init, coeff policies."),
    "ornstein-uhlenbeck": dict(
        kind="block", parent="walker", usage="ornstein-uhlenbeck ... end",
        short="Start the Ornstein-Uhlenbeck SDE block",
        long="OU process with full covariance sigmasq (upper triangle), "
             "theta, mu."),
    "beta": dict(
        kind="block", parent="walker", usage="beta ... end",
        short="Start the beta SDE block",
        long="Beta distribution SDE: b, S, kappa coefficient vectors."),
    "numfracbeta": dict(
        kind="block", parent="walker", usage="numfracbeta ... end",
        short="Start the number-fraction beta SDE block",
        long="Beta SDE for mole fractions X, plus rho2/rcomma derived "
             "densities."),
    "massfracbeta": dict(
        kind="block", parent="walker", usage="massfracbeta ... end",
        short="Start the mass-fraction beta SDE block",
        long="Beta SDE for mass fractions Y, plus rho2/r derived "
             "densities."),
    "mixnumfracbeta": dict(
        kind="block", parent="walker", usage="mixnumfracbeta ... end",
        short="Start the mix number-fraction beta SDE block",
        long="Mix model: b' and kappa' coefficients derived from "
             "turbulent mixing; rho2/rcomma."),
    "mixmassfracbeta": dict(
        kind="block", parent="walker", usage="mixmassfracbeta ... end",
        short="Start the mix mass-fraction beta SDE block",
        long="Mix model for mass fractions: bprime/kappaprime vectors, "
             "rho2/r, and the decay/homdecay/montecarlo_homdecay/"
             "hydrotimescale coefficient closures."),
    "dirichlet": dict(
        kind="block", parent="walker", usage="dirichlet ... end",
        short="Start the Dirichlet SDE block",
        long="Dirichlet distribution SDE: b, S, kappa vectors."),
    "gendir": dict(
        kind="block", parent="walker", usage="gendir ... end",
        short="Start the generalized Dirichlet SDE block",
        long="Lochner's generalized Dirichlet SDE: b, S, kappa, cij."),
    "mixdirichlet": dict(
        kind="block", parent="walker", usage="mixdirichlet ... end",
        short="Start the MixDirichlet SDE block",
        long="Dirichlet mix model with density-conditioned S update: "
             "b, S, kappa, rho vectors."),
    "skew-normal": dict(
        kind="block", parent="walker", usage="skew-normal ... end",
        short="Start the skew-normal SDE block",
        long="Skew-normal distribution SDE: T, sigmasq, lambda."),
    "wright-fisher": dict(
        kind="block", parent="walker", usage="wright-fisher ... end",
        short="Start the Wright-Fisher SDE block",
        long="Wright-Fisher population-genetics SDE: omega vector."),
    "position": dict(
        kind="block", parent="walker", usage="position ... end",
        short="Start the particle position equation block",
        long="dx = u dt coupled to a velocity model (solve "
             "fullvar/fluctuation)."),
    "dissipation": dict(
        kind="block", parent="walker", usage="dissipation ... end",
        short="Start the turbulence-frequency (dissipation) block",
        long="Gamma-distribution model for turbulence frequency "
             "coupled to velocity."),
    "velocity": dict(
        kind="block", parent="walker", usage="velocity ... end",
        short="Start the Langevin velocity model block",
        long="Simplified/generalized Langevin velocity SDE coupled to "
             "position and dissipation; C0, solve, variant."),
}


def format_keyword_help(kw: Optional[str] = None) -> str:
    """Help page text: all keywords (kw None) or one keyword's page."""
    if kw:
        e = KEYWORDS.get(kw)
        if e is None:
            near = [k for k in sorted(KEYWORDS) if kw in k or k in kw]
            hint = f"  (did you mean: {', '.join(near)}?)" if near else ""
            return f"unknown control-file keyword '{kw}'{hint}"
        return (f"{kw} — {e['short']}\n"
                f"   kind:  {e['kind']} (inside: {e['parent']})\n"
                f"   usage: {e['usage']}\n"
                f"   {e['long']}")
    lines = ["Control-file keywords (use -H <keyword> for details):", ""]
    for k in sorted(KEYWORDS):
        lines.append(f"  {k:18s} {KEYWORDS[k]['short']}")
    return "\n".join(lines)
