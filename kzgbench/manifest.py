"""BENCHMARK.json and the benchmark's files, found by the names in it:
kzgbench/configs/<config>.json (the configuration's file as the manifest
gives it), kzgbench/traffic/<traffic>.json, kzgbench/metrics/<metric>.json
and kzgbench/readers/<reader>.py.  A later cell or metric adds files and
entries; it edits none of these."""

from __future__ import annotations

import importlib.util
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load(root: str = ROOT) -> dict:
    return _json(os.path.join(root, "BENCHMARK.json"))


def workload(manifest: dict, name: str) -> dict:
    for w in manifest["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(manifest: dict, name: str, root: str = ROOT) -> dict:
    for c in manifest["configs"]:
        if c["name"] == name:
            return _json(os.path.join(root, c["file"]))
    raise KeyError(f"no config {name!r} in BENCHMARK.json")


def traffic(name: str) -> dict:
    return _json(os.path.join(HERE, "traffic", f"{name}.json"))


def metric(name: str) -> dict:
    return _json(os.path.join(HERE, "metrics", f"{name}.json"))


def reader(kind: str):
    path = os.path.join(HERE, "readers", f"{kind}.py")
    spec = importlib.util.spec_from_file_location(f"kzgbench_reader_{kind}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_metrics(manifest: dict, cell: str, trace: bool) -> list[dict]:
    """The end-to-end metrics a cell reports (trace off) or its per-layer
    metrics (trace on): those whose `workloads` list it, or that have
    none."""
    group = manifest["per_layer" if trace else "end_to_end"]
    return [m for m in group if cell in m.get("workloads", [cell])]
