"""Nothing of the benchmark imports JAX or the JAX package (top-level
module names compared whole: the port's name begins with the JAX
package's), and the plain reference imports nothing of the port."""

import ast
import os

from benchlib import catalog

FORBIDDEN = {"jax", "jaxlib", "flax", "quinoa_tpu"}


def _imports(path):
    with open(path) as fh:
        tree = ast.parse(fh.read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


def _sources(*parts):
    top = os.path.join(catalog.ROOT, *parts)
    for d, _, files in os.walk(top):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_no_jax_anywhere():
    found = {p: _imports(p) & FORBIDDEN for p in _sources()}
    assert not {p: n for p, n in found.items() if n}


def test_quinoa_tpu_torch_is_not_quinoa_tpu():
    assert "quinoa_tpu_torch".split(".")[0] not in FORBIDDEN


def test_reference_imports_nothing_of_the_port():
    configs = [catalog.config(c) for c in os.listdir(os.path.join(catalog.ROOT, "configs"))]
    paths = list(_sources("reference")) + [
        os.path.join(c["dir"], "reference.py") for c in configs]
    assert paths
    for p in paths:
        assert not (_imports(p) & (FORBIDDEN | {"quinoa_tpu_torch", "benchlib"})), p


def test_forbidden_modules_compares_whole_names():
    import sys

    from benchlib.harness import forbidden_modules

    sys.modules["quinoa_tpu_torch_fake"] = sys  # a name that begins alike
    try:
        assert "quinoa_tpu" not in forbidden_modules()
    finally:
        del sys.modules["quinoa_tpu_torch_fake"]


def test_a_module_loaded_after_the_window_fails_the_run(monkeypatch):
    """The look for JAX is the run's last step: a per-layer reader that
    loads a forbidden module leaves the run with no result."""
    import sys
    import types

    import pytest

    from benchlib import harness

    class Reader:
        UNIT = "s"

        @staticmethod
        def read(run):
            sys.modules["jaxlib"] = types.ModuleType("jaxlib")
            return 1.0

    monkeypatch.setattr(harness.catalog, "metric_readers", lambda: {"late": Reader})
    monkeypatch.delitem(sys.modules, "jaxlib", raising=False)
    try:
        with pytest.raises(harness.ForbiddenModule):
            harness.run_cell("sedov_dgp1.64", 2**31 + 5, 0.2, trace=True,
                             device="cpu", dims=(3, 3, 3), log=lambda s: None,
                             trace_steps=2)
    finally:
        sys.modules.pop("jaxlib", None)
