"""BENCHMARK.json against the benchmark's files and the contract's form,
and a run without a card."""

from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
import sys

import pytest

from kzgbench import generator, manifest
from kzgbench.readers import roofline

REPO = manifest.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {
    "top": {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"},
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source", "workloads"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves", "workloads"},
}


@pytest.fixture(scope="module")
def m():
    return manifest.load()


def line(s: str) -> bool:
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_form(m):
    assert set(m) == KEYS["top"]
    assert os.path.getsize(os.path.join(REPO, "BENCHMARK.json")) <= 64 * 1024
    assert m["command"] == ["python3", "kzgbench/run.py"] and m["paths"] == ["kzgbench"]
    assert 1 <= m["run_seconds"] <= 51
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in m[group]:
            assert set(e) <= KEYS[group] and set(e) >= KEYS[group] - {"workloads"}, e
            assert NAME.match(e["name"]), e["name"]
            names.append(e["name"])
            if "unit" in e:
                assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
                assert e["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
            for k in ("why", "layer", "source"):
                assert k not in e or line(e[k])
    assert len(names) == len(set(names))
    for c in m["configs"]:
        assert c["reduced"] == []
    for w in m["workloads"]:
        assert w["chips"] == 1 and NAME.match(w["traffic"]) and NAME.match(w["config"])
    for e in m["end_to_end"]:
        assert e["source"] in ("host_clock", "device_trace") and 0 < e["bound"] <= 0.25
    setup = {e["name"]: e for e in m["end_to_end"]}["setup_s"]
    assert setup["bound"] == 0.25 and "workloads" not in setup
    for e in m["per_layer"]:
        if e["unit"] == "%" and "roofline" in e["name"]:
            assert e["name"].split(".")[0].endswith("_roofline")


def test_every_name_resolves_to_its_file(m):
    cells = {w["name"] for w in m["workloads"]}
    for c in m["configs"]:
        config = manifest.config(m, c["name"])
        assert c["file"].startswith("kzgbench/configs/") and config["name"] == c["name"]
        assert config["source"] == c["source"]
        assert os.path.exists(os.path.join(REPO, config["setup"]))
        assert any(w["config"] == c["name"] for w in m["workloads"])
    for w in m["workloads"]:
        t = manifest.traffic(w["traffic"])
        entry = generator.entry(t["entry"])
        assert callable(entry.draw) and callable(entry.run) and callable(entry.judge)
        assert callable(generator.loop(t["loop"]).drive)
    for e in m["end_to_end"] + m["per_layer"]:
        assert set(e.get("workloads", cells)) <= cells
        spec = manifest.metric(e["name"])
        reader = manifest.reader(spec["reader"])
        assert callable(reader.read)
        if spec["reader"] == "roofline":
            mod = roofline.load(spec["count"])
            assert mod.KERNEL and callable(mod.work)


def test_every_per_layer_metric_moves_an_end_to_end_metric_its_cells_report(m):
    cells = [w["name"] for w in m["workloads"]]
    e2e = {e["name"]: set(e.get("workloads", cells)) for e in m["end_to_end"]}
    for e in m["per_layer"]:
        assert e["moves"] in e2e, e["name"]
        assert set(e.get("workloads", cells)) <= e2e[e["moves"]], e["name"]
    for cell in cells:
        names = [e["name"] for e in manifest.cell_metrics(m, cell, False)]
        assert "setup_s" in names and len(names) >= 2
        assert manifest.cell_metrics(m, cell, True)


def test_roofline_counts():
    """The least times the counts give at a batch of 64: K8's 22 x 64 x
    4096 mixed additions of 11 products of 300 wide multiplies at
    8.36352e12 a second; and the cells' 6-blob batches, 6/64 of it."""
    shape = {"batch": 64, "n": 4096, "comb_h": 12, "msm_window": 8}
    k8 = roofline.least_seconds(roofline.load("k8").work(shape))
    assert k8 == pytest.approx(22 * 64 * 4096 * 11 * 300 / 8.36352e12)
    k3 = roofline.least_seconds(roofline.load("k3").work(shape))
    assert k3 == pytest.approx(321 * 256 * 20 * 300 / 8.36352e12)
    k7 = roofline.least_seconds(roofline.load("k7").work(shape))
    assert k7 == pytest.approx(64 * 4096 * 11 * 300 / 8.36352e12)
    k6 = roofline.least_seconds(roofline.load("k6").work({**shape, "batch": 1}))
    assert k6 == pytest.approx(256 * 58 * 300 / 8.36352e12)
    six = {**shape, "batch": 6}
    assert roofline.least_seconds(roofline.load("k8").work(six)) == pytest.approx(k8 * 6 / 64)
    assert roofline.least_seconds(roofline.load("k3").work(six)) == pytest.approx(k3 * 31 / 321)


def _run(cwd: str) -> subprocess.CompletedProcess:
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable, "kzgbench/run.py", "--workload", "precompile", "--seed",
                           str(2**31 + 7), "--seconds", "1", "--trace", "0"],
                          cwd=cwd, env=env, capture_output=True, text=True, timeout=300)


def test_a_run_without_a_card_fails_and_prints_no_result():
    out = _run(REPO)
    assert out.returncode != 0
    assert "{" not in out.stdout
    assert "CUDA device" in out.stderr


def test_a_run_with_only_the_benchmark_fails(tmp_path):
    """A checkout that holds only BENCHMARK.json and kzgbench/ exits with
    an error and prints no result."""
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(REPO, "kzgbench"), tmp_path / "kzgbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(str(tmp_path))
    assert out.returncode != 0 and "{" not in out.stdout
