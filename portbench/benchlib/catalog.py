"""Finds the benchmark's data by name: cells/<cell>.json, configs/<config>/
(config.json, deck.q, program.py, reference.py), traffic/<traffic>.json,
metrics/<metric>.py and work/<operation>.py.  Adding a cell, a
configuration, a traffic mix, a per-layer metric or an operation is adding
files; nothing here lists them."""

from __future__ import annotations

import importlib.util
import json
import os

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _json(*parts):
    with open(os.path.join(ROOT, *parts)) as fh:
        return json.load(fh)


def _names(sub, suffix):
    d = os.path.join(ROOT, sub)
    return sorted(f[:-len(suffix)] for f in os.listdir(d)
                  if f.endswith(suffix) and not f.startswith("_"))


def load_module(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cells():
    return _names("cells", ".json")


def cell(name):
    """The cell's file with its configuration and traffic resolved."""
    if name not in cells():
        raise KeyError(f"no cell {name!r} in {os.path.join(ROOT, 'cells')}")
    c = _json("cells", f"{name}.json")
    c["name"] = name
    c["config"] = config(c["config"])
    c["traffic"] = dict(_json("traffic", f"{c['traffic']}.json"),
                        name=c["traffic"])
    return c


def config(name):
    d = os.path.join(ROOT, "configs", name)
    c = _json("configs", name, "config.json")
    with open(os.path.join(d, "deck.q")) as fh:
        c["deck_text"] = fh.read()
    c["name"], c["dir"] = name, d
    return c


def config_module(cfg, which):
    """The configuration's program or reference module,
    configs/<config>/<which>.py."""
    return load_module(os.path.join(cfg["dir"], f"{which}.py"),
                       f"portbench_{cfg['name']}_{which}")


def metric_readers():
    """{metric name: module with UNIT and read(run)} from metrics/."""
    return {n: load_module(os.path.join(ROOT, "metrics", f"{n}.py"),
                           f"portbench_metric_{n}")
            for n in _names("metrics", ".py")}


def work(op):
    """work/<op>.py, whose nbytes(shapes) counts the operation's bytes."""
    path = os.path.join(ROOT, "work", f"{op}.py")
    if not os.path.exists(path):
        return None
    return load_module(path, f"portbench_work_{op}")
