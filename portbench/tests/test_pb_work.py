"""The operations' byte counts at the cells' shapes."""

from benchlib import catalog

E = 1572864


def test_face_pass_bytes():
    w = catalog.work("face_pass")
    # Sedov: state 20 rows in, rhs 20 rows and delt out, float32
    assert w.nbytes({"nelem": E, "state_rows": 20, "face_rows": 20,
                     "itemsize": 4}) == 4 * E * 41 == 257949696
    # multimat: 36 rows in; 36 + 3*2 + 1 rows and delt out
    assert w.nbytes({"nelem": E, "state_rows": 36, "face_rows": 43,
                     "itemsize": 4}) == 4 * E * 80


def test_limit_volume_bytes():
    w = catalog.work("limit_volume")
    assert w.nbytes({"nelem": E, "state_rows": 20, "itemsize": 4}) == 4 * E * 60
    assert w.nbytes({"nelem": E, "state_rows": 36, "itemsize": 4}) == 4 * E * 108


def test_missing_operation_reads_nothing():
    from benchlib.harness import Run

    assert catalog.work("no_such_operation") is None
    assert Run().op_bytes("face_pass") is None
    for mod in catalog.metric_readers().values():
        assert mod.read(Run()) is None
