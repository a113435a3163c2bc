"""Bytes of the face pass, from the cell's shapes: the state (state_rows,
E) read once, the face rhs (face_rows, E) and the per-element summed
characteristic speed (E,) written once.  The geometry tables are not
counted, so the share of the roofline is of this traffic alone."""


def nbytes(sh):
    return sh["itemsize"] * sh["nelem"] * (sh["state_rows"] + sh["face_rows"] + 1)
