"""The port stands alone: no module of kateth_tpu_torch, and neither
chip_smoke.py nor the port's tools/profile_*.py scripts, imports jax or the
JAX package; its entry points default to CUDA and refuse to run elsewhere
unless the caller names the device."""

import ast
import os
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "kateth_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "kateth_tpu")


def _sources():
    out = [os.path.join(REPO, "chip_smoke.py")]
    out += [os.path.join(REPO, "tools", f"profile_torch_{n}.py") for n in ("verify", "commit")]
    out += [os.path.join(REPO, "tools", n) for n in ("profile_team_kernels.py", "profile_torch_k1.py")]
    for root, _, files in os.walk(PKG):
        out += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _imported(path: str):
    """Absolute module names imported by a source file, with relative
    imports resolved against its package."""
    package = os.path.relpath(path, REPO).split(os.sep)[:-1]
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0:
                yield node.module
            elif node.level - 1 >= len(package):
                yield "<beyond the package root>"
            else:
                base = package[: len(package) - (node.level - 1)]
                if node.module:
                    yield ".".join(base + [node.module])
                else:
                    for alias in node.names:
                        yield ".".join(base + [alias.name])


@pytest.mark.parametrize("path", _sources(), ids=lambda p: os.path.relpath(p, REPO))
def test_no_jax_or_reference_imports(path):
    for name in _imported(path):
        top = name.split(".")[0]
        assert top not in FORBIDDEN, f"{path} imports {name}"
        assert name != "<beyond the package root>", f"{path} imports past the package root"


@pytest.mark.parametrize("module", ["specs", "limbs", "cuda_mont"])
def test_fields_import_in_any_order(module):
    """limbs and the kernel wrappers of cuda_mont import each other (limbs
    binds cuda_mont at its first product), so each of the three, imported
    first in a fresh interpreter, loads and runs a product."""
    code = (f"import kateth_tpu_torch.fields.{module}\n"
            "import torch\n"
            "from kateth_tpu_torch.fields import limbs as L\n"
            "from kateth_tpu_torch.fields.specs import FR\n"
            "one = FR.tensor('one_mont', 'cpu')\n"
            "assert torch.equal(L.mont_mul(FR, one, one), one)\n")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True)


def test_import_walk_sees_relative_imports():
    names = set(_imported(os.path.join(PKG, "kzg", "api.py")))
    assert "kateth_tpu_torch.host" in names and "kateth_tpu_torch.kzg.protocol" in names


def test_load_json_defaults_to_cuda(tmp_path, monkeypatch):
    """With no CUDA device, device=None raises instead of running on the
    CPU (it fails before reading the file)."""
    from kateth_tpu_torch.kzg import Kzg
    from kateth_tpu_torch.kzg.setup import TorchSetup

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    missing = str(tmp_path / "no_such_setup.json")
    with pytest.raises(RuntimeError, match="CUDA"):
        Kzg.load_json(missing)
    with pytest.raises(RuntimeError, match="CUDA"):
        TorchSetup.load_json(missing, device=None)
    with pytest.raises(FileNotFoundError):
        Kzg.load_json(missing, device="cpu")


def _init_backend(monkeypatch, **kw):
    """The backend distributed_init asks torch.distributed for."""
    import torch.distributed as dist

    from kateth_tpu_torch.parallel import distributed_init

    seen = []
    monkeypatch.setattr(dist, "is_initialized", lambda: False)
    monkeypatch.setattr(dist, "init_process_group", lambda backend, **_: seen.append(backend))
    distributed_init(init_method="tcp://localhost:1", rank=0, world_size=1, **kw)
    return seen[0]


@pytest.mark.parametrize("entry", ["local_device", "distributed_init"])
def test_parallel_entry_points_default_to_cuda(entry, monkeypatch):
    """kateth_tpu_torch.parallel: with no CUDA device, local_device raises
    unless the caller names the CPU, and the process group is NCCL unless
    the caller names gloo or the CPU."""
    from kateth_tpu_torch.parallel import local_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    if entry == "local_device":
        with pytest.raises(RuntimeError, match="CUDA"):
            local_device(0)
        assert local_device(0, device="cpu") == torch.device("cpu")
    else:
        assert _init_backend(monkeypatch) == "nccl"
        assert _init_backend(monkeypatch, device="cpu") == "gloo"
        assert _init_backend(monkeypatch, backend="gloo") == "gloo"
