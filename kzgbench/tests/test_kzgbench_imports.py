"""What the benchmark imports: nothing whose top-level name is jax, jaxlib,
flax or kateth_tpu (compared whole: kateth_tpu_torch begins with
kateth_tpu), and, in its reference, nothing of the port."""

from __future__ import annotations

import ast
import glob
import os
import subprocess
import sys

from kzgbench import manifest

HERE = os.path.join(manifest.ROOT, "kzgbench")
FORBIDDEN = {"jax", "jaxlib", "flax", "kateth_tpu"}


def imported(path: str) -> set[str]:
    """Top-level names of the modules a file imports (relative imports are
    the benchmark's own)."""
    with open(path) as f:
        tree = ast.parse(f.read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def sources(*parts: str) -> list[str]:
    return [p for p in glob.glob(os.path.join(HERE, *parts, "**", "*.py"), recursive=True)
            if os.sep + "tests" + os.sep not in p]


def test_no_module_of_the_benchmark_imports_jax_or_the_jax_package():
    for path in sources():
        assert not imported(path) & FORBIDDEN, path


def test_the_reference_imports_nothing_of_the_port():
    allowed = {"__future__", "hashlib", "operator", "kzgbench"}
    for path in sources("reference"):
        assert imported(path) <= allowed, (path, imported(path))


def test_only_the_program_module_imports_the_port():
    users = [p for p in sources() if "kateth_tpu_torch" in imported(p)]
    assert users == [os.path.join(HERE, "program.py")]


def test_a_run_loads_no_jax():
    """The modules run.py loads, the port's among them, leave no forbidden
    top-level name in sys.modules; and the run's own check finds one."""
    code = (
        "import sys; sys.argv = ['run.py']\n"
        "sys.path.insert(0, 'kzgbench')\n"
        "import run\n"
        "sys.path.insert(0, '.')\n"
        "from kzgbench import harness, program, control\n"
        "import kateth_tpu_torch.kzg\n"
        "assert run.forbidden_modules() == [], run.forbidden_modules()\n"
        "import types; sys.modules['kateth_tpu.oracle'] = types.ModuleType('kateth_tpu.oracle')\n"
        "sys.modules['jaxlib'] = types.ModuleType('jaxlib')\n"
        "assert run.forbidden_modules() == ['jaxlib', 'kateth_tpu'], run.forbidden_modules()\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=manifest.ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
