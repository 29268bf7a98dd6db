"""The set-up's child process: it runs, before the measured process
touches the card, exactly when the kernels or the setup's cache are
missing, and its output goes to standard error."""

from __future__ import annotations

import json
import sys

import pytest

from kzgbench import program

CONFIG = {"setup": "kzgbench/data/setup_known_tau_4096.json",
          "kzg_config": {"n": 4096, "g2_len": 65, "comb_h": 12, "msm_window": 8, "canon_batch": 64}}


@pytest.mark.parametrize("built,cached,runs", [(True, True, False), (False, True, True),
                                               (True, False, True), (False, False, True)])
def test_the_child_runs_when_something_is_missing(monkeypatch, built, cached, runs):
    calls = []
    monkeypatch.setattr(program, "_built", lambda: built)
    monkeypatch.setattr(program, "_setup_cached", lambda config, root: cached)
    monkeypatch.setattr(program.subprocess, "run", lambda cmd, **kw: calls.append((cmd, kw)))
    program.prepare(CONFIG, program.ROOT)
    assert len(calls) == runs
    if runs:
        cmd, kw = calls[0]
        assert cmd[:2] == [sys.executable, program.__file__] and json.loads(cmd[2]) == CONFIG
        assert kw["stdout"] is sys.stderr and kw["check"] and kw["cwd"] == program.ROOT


def test_the_setup_cache_is_looked_for_inside_the_checkout(tmp_path):
    assert program.setup_cache_dir(str(tmp_path)).startswith(str(tmp_path))
    (tmp_path / "kzgbench" / "data").mkdir(parents=True)
    (tmp_path / CONFIG["setup"]).write_bytes(b"{}")
    assert not program._setup_cached(CONFIG, str(tmp_path))
