"""Cells, configurations and metrics are found by name: adding a cell is
adding a file."""

import json
import os
import shutil
import subprocess
import sys

from benchlib import catalog

ROOT = catalog.ROOT
REPO = os.path.dirname(ROOT)


def test_benchmark_json_matches_the_files():
    with open(os.path.join(REPO, "BENCHMARK.json")) as fh:
        b = json.load(fh)
    assert {w["name"] for w in b["workloads"]} <= set(catalog.cells())
    for w in b["workloads"]:
        c = catalog.cell(w["name"])
        assert c["config"]["name"] == w["config"]
        assert c["traffic"]["name"] == w["traffic"]
        assert c["chips"] == w["chips"]
    for cfg in b["configs"]:
        c = catalog.config(cfg["name"])
        assert os.path.join("portbench", "configs", cfg["name"], "config.json") == cfg["file"]
        assert c["source"] == cfg["source"] and c["reduced"] == cfg["reduced"]
    readers = catalog.metric_readers()
    assert sorted(readers) == sorted(m["name"] for m in b["per_layer"])
    for m in b["per_layer"]:
        assert readers[m["name"]].UNIT == m["unit"]


def test_a_new_cell_is_a_new_file(tmp_path):
    """In a copy of portbench/, one added cell file is listed and resolved
    by the harness with no other edit."""
    copy = tmp_path / "portbench"
    shutil.copytree(ROOT, copy, ignore=shutil.ignore_patterns("__pycache__"))
    (copy / "traffic" / "cube96.json").write_text('{"cells": [96, 96, 96]}\n')
    cell = json.loads((copy / "cells" / "sedov_dgp1.64.json").read_text())
    cell["traffic"] = "cube96"
    (copy / "cells" / "sedov_dgp1.96.json").write_text(json.dumps(cell))
    code = ("import sys; sys.path.insert(0, sys.argv[1]); from benchlib import catalog; "
            "print(catalog.cells()); print(catalog.cell('sedov_dgp1.96')['traffic'])")
    out = subprocess.run([sys.executable, "-c", code, str(copy)],
                         capture_output=True, text=True, check=True).stdout
    assert "sedov_dgp1.96" in out and "[96, 96, 96]" in out
