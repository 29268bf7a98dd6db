"""The system under test, kateth_tpu_torch, as the harness drives it: the
one module of the benchmark that imports the port.  Nothing else of the
port is read: the harness hands it the inputs and judges what its public
calls return.

Before the measured process touches the card, a child process builds the
kernels and writes the setup's cache, where either is missing, and ends:
so every run, the first in a checkout too, measures a process that loads
both from their caches.  Run as a script, this file is that child:

  python3 kzgbench/program.py '<the configuration as JSON>'"""

from __future__ import annotations

import hashlib
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def setup_cache_dir(root: str) -> str:
    return os.path.join(root, ".cache", "kzgbench", "setup")


def _setup_cached(config: dict, root: str) -> bool:
    """Whether the setup's .npz cache is there, under the name that
    TorchSetup.load_json gives it (a later name only makes the child run)."""
    with open(os.path.join(root, config["setup"]), "rb") as f:
        key = hashlib.sha256(f.read()).hexdigest()[:16]
    kc = config["kzg_config"]
    return os.path.exists(os.path.join(setup_cache_dir(root), f"setup_{key}_{kc['n']}_{kc['g2_len']}.npz"))


def _built() -> bool:
    from kateth_tpu_torch import cuda_lib

    return all(os.path.exists(os.path.join(cuda_lib.build_dir(), f"lib{name}.so"))
               for name in cuda_lib.LIBRARIES)


def prepare(config: dict, root: str) -> None:
    """Build and cache in a child process what this checkout lacks."""
    if _built() and _setup_cached(config, root):
        return
    subprocess.run([sys.executable, os.path.abspath(__file__), json.dumps(config)], cwd=root,
                   stdout=sys.stderr, check=True)


class Port:
    """A Kzg of the configuration on the first CUDA device, its setup cached
    at a fixed directory inside the checkout."""

    cuda = True

    def __init__(self, config: dict, root: str):
        import torch
        from kateth_tpu_torch.kzg import Kzg, KzgConfig

        prepare(config, root)
        self._torch = torch
        self.kzg = Kzg.load_json(
            os.path.join(root, config["setup"]), KzgConfig(**config["kzg_config"]), device="cuda",
            cache_dir=setup_cache_dir(root))

    def synchronize(self) -> None:
        self._torch.cuda.synchronize()

    def peak_bytes(self) -> int:
        return self._torch.cuda.max_memory_reserved()

    def device(self) -> dict:
        return {"platform": "gpu", "kind": self._torch.cuda.get_device_name(0), "count": 1}

    def close(self) -> None:
        """Free the program's state before the reference runs."""
        self.kzg = None
        self._torch.cuda.synchronize()
        self._torch.cuda.empty_cache()


class StandIn:
    """Any object with the Kzg calls in the program's place, on the host:
    the reference (kzgbench/reference/port.py) for the control and the
    tests."""

    cuda = False

    def __init__(self, kzg):
        self.kzg = kzg

    def synchronize(self) -> None:
        pass

    def peak_bytes(self) -> int:
        return 0

    def device(self) -> dict:
        return {"platform": "cpu", "kind": "stand-in", "count": 0}

    def close(self) -> None:
        pass


def _child(config: dict) -> None:
    from kateth_tpu_torch import cuda_lib
    from kateth_tpu_torch.kzg import KzgConfig, TorchSetup

    print(f"kzgbench: kernels built in {cuda_lib.build_all():.1f} s", flush=True)
    if not _setup_cached(config, ROOT):
        TorchSetup.load_json(os.path.join(ROOT, config["setup"]), KzgConfig(**config["kzg_config"]),
                             device="cuda", cache_dir=setup_cache_dir(ROOT))
        print("kzgbench: setup cached", flush=True)


if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    _child(json.loads(sys.argv[1]))
