"""Bytes of the limit-and-volume stage, from the cell's shapes: the state
(state_rows, E) read once, the limited state and the volume rhs (each
state_rows, E) written once.  The geometry tables are not counted."""


def nbytes(sh):
    return sh["itemsize"] * sh["nelem"] * 3 * sh["state_rows"]
