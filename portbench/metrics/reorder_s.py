"""Set-up: seconds of the port's Hilbert element reorder
(mesh/reorder.py hilbert_element_reorder), harness clock around the call."""

UNIT = "s"


def read(run):
    return run.reorder_s
