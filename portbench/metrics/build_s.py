"""Set-up: seconds of the port's solver build and initial state
(control/config.py build_inciter, which runs pde/dg.py build_dggeom, then
solver.initial_state()), harness clock around both, ending in a
synchronize."""

UNIT = "s"


def read(run):
    return run.build_s
