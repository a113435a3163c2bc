"""Bytes of the p-adaptive limit pass, from the cell's shapes: the state
(state_rows, E) read once and the limited, masked state written once,
the dof counts (E,) int32 read and written once.  The geometry tables
and the neighbours' means are not counted."""


def nbytes(sh):
    return sh["itemsize"] * sh["nelem"] * 2 * sh["state_rows"] + 8 * sh["nelem"]
