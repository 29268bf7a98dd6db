"""The trusted setup as tensors on one device.

`TorchSetup.load_json` parses the ceremony JSON, decompresses the G1
Lagrange points on the device (square root by kernel K2, subgroup check by
kernel K3 on a CUDA device), decompresses and checks the G2 points on the
host, and applies the bit-reversal permutation to the G1 table and the
roots of unity.  The result is cached as an .npz of digit planes under
~/.cache/kateth_tpu_torch, keyed on the file's contents.  Any invalid point
raises KzgError.
"""

from __future__ import annotations

import hashlib
import json
import os
from dataclasses import dataclass

import numpy as np
import torch

from .. import host
from ..curves import decompress
from ..curves import g2 as g2mod
from ..fields.specs import FR
from .config import MAINNET, KzgConfig

DEFAULT_CACHE_DIR = os.path.join(os.path.expanduser("~"), ".cache", "kateth_tpu_torch")

#: the vendored mainnet trusted setup, shipped with the JAX package's data
DEFAULT_TRUSTED_SETUP = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "kateth_tpu",
    "data",
    "trusted_setup_4096.json",
)

#: the eight tensors of a setup, in order
FIELDS = ("g1x", "g1y", "g1z", "tau2x", "tau2y", "tau2z", "roots", "inv_roots")


@dataclass(frozen=True)
class TorchSetup:
    g1x: torch.Tensor  # (N, 24) Montgomery, BRP order
    g1y: torch.Tensor
    g1z: torch.Tensor
    tau2x: torch.Tensor  # (2, 24) [tau]_2 projective
    tau2y: torch.Tensor
    tau2z: torch.Tensor
    roots: torch.Tensor  # (N, 16) Montgomery Fr, BRP order
    inv_roots: torch.Tensor  # (N, 16) Montgomery Fr, BRP order
    config: KzgConfig = MAINNET

    @property
    def device(self) -> torch.device:
        return self.roots.device

    @property
    def g1_points(self):
        return (self.g1x, self.g1y, self.g1z)

    @property
    def tau2(self):
        return (self.tau2x, self.tau2y, self.tau2z)

    @classmethod
    def from_arrays(cls, arrays, config: KzgConfig, device) -> "TorchSetup":
        """Build from the eight digit-plane arrays, in FIELDS order (for
        example the JAX package's DeviceSetup fields as numpy)."""
        tensors = [torch.as_tensor(np.asarray(a, dtype=np.int64)).to(device) for a in arrays]
        if len(tensors) != len(FIELDS):
            raise ValueError(f"expected {len(FIELDS)} arrays")
        if tensors[0].shape != (config.n, 24) or tensors[6].shape != (config.n, 16):
            raise ValueError("setup arrays do not match the config")
        return cls(*tensors, config=config)

    @classmethod
    def _from_json(cls, raw: bytes, config: KzgConfig, device) -> "TorchSetup":
        obj = json.loads(raw)
        g1_hex, g2_hex = obj["g1_lagrange"], obj["g2_monomial"]
        if len(g1_hex) != config.n or len(g2_hex) != config.g2_len:
            raise host.KzgError("trusted setup has wrong point counts")

        def unhex(h):
            return bytes.fromhex(h[2:] if h.startswith("0x") else h)

        g1b = np.frombuffer(b"".join(unhex(h) for h in g1_hex), dtype=np.uint8)
        g1b = torch.as_tensor(g1b.reshape(config.n, 48).copy()).to(device)
        pt, enc, curve, sub = decompress.g1_decompress(g1b)
        if not bool((enc & curve & sub).all()):
            raise host.KzgError("invalid G1 point in trusted setup")
        try:  # every G2 point is checked; only [tau]_2 is kept
            g2 = [host.g2_decompress(unhex(h)) for h in g2_hex]
        except host.DecompressError as e:
            raise host.KzgError(f"invalid G2 point in trusted setup: {e}") from e
        t2x, t2y, t2z = g2mod.from_ints([g2[1]])

        brp = host.brp_indices(config.n)
        roots_nat = host.roots_of_unity(config.n)
        roots = [roots_nat[i] for i in brp]
        g1 = [c[torch.as_tensor(brp, device=device)].cpu().numpy() for c in pt]
        return cls.from_arrays(
            g1
            + [t2x[0], t2y[0], t2z[0]]
            + [np.stack([FR.from_int(r) for r in roots])]
            + [np.stack([FR.from_int(pow(r, host.R - 2, host.R)) for r in roots])],
            config,
            device,
        )

    @classmethod
    def load_json(
        cls,
        path: str,
        config: KzgConfig = MAINNET,
        device=None,
        cache_dir: str | None = DEFAULT_CACHE_DIR,
    ) -> "TorchSetup":
        """Parse and validate a trusted-setup JSON onto `device` (default
        CUDA; raises when there is none), with an .npz cache keyed on the
        file's contents."""
        device = _device(device)
        with open(path, "rb") as f:
            raw = f.read()
        cache = None
        if cache_dir is not None:
            key = hashlib.sha256(raw).hexdigest()[:16]
            cache = os.path.join(cache_dir, f"setup_{key}_{config.n}_{config.g2_len}.npz")
            if os.path.exists(cache):
                with np.load(cache) as z:
                    return cls.from_arrays([z[k] for k in FIELDS], config, device)
        out = cls._from_json(raw, config, device)
        if cache is not None:
            os.makedirs(cache_dir, exist_ok=True)
            tmp = cache + f".{os.getpid()}.tmp.npz"
            np.savez(tmp, **{k: getattr(out, k).cpu().numpy() for k in FIELDS})
            os.replace(tmp, cache)
        return out


def _device(device) -> torch.device:
    """The device to run on: CUDA unless the caller names another."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: pass device='cpu' to run the plain PyTorch path"
            )
        return torch.device("cuda")
    return torch.device(device)
