"""The trusted setup as tensors on one device.

`TorchSetup.load_json` parses the ceremony JSON and decompresses every point
on the setup's device: the 4096 G1 Lagrange points (square root by kernel
K2, subgroup check by kernel K3 on a CUDA device) and the 65 G2 monomial
points (the Fp2 square root's chains on the plain Fp2 products, whose
Montgomery products are kernel K1; the subgroup check by kernel K6).  Any
point that fails its encoding, curve or subgroup check raises KzgError.
It keeps [tau]_2, applies the bit-reversal permutation to the G1 table and
the roots of unity, and caches the result as an .npz of digit planes under
~/.cache/kateth_tpu_torch, keyed on the file's contents.
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

        def points(hexes, width, group):
            raw = [unhex(h) for h in hexes]
            if any(len(b) != width for b in raw):
                raise host.KzgError(f"invalid {group} point in trusted setup")
            arr = np.frombuffer(b"".join(raw), dtype=np.uint8).reshape(len(raw), width)
            return torch.as_tensor(arr.copy()).to(device)

        pt, enc, curve, sub = decompress.g1_decompress(points(g1_hex, 48, "G1"))
        if not bool((enc & curve & sub).all()):
            raise host.KzgError("invalid G1 point in trusted setup")
        # every G2 point is checked, its encoding and curve before the
        # subgroup; only [tau]_2 is kept
        pt2, enc, curve = decompress.g2_decompress_nosub(points(g2_hex, 96, "G2"))
        if not bool((enc & curve).all()) or not bool(decompress.g2_subgroup_check(pt2).all()):
            raise host.KzgError("invalid G2 point in trusted setup")

        brp = host.brp_indices(config.n)
        roots_nat = host.roots_of_unity(config.n)
        roots = [roots_nat[i] for i in brp]
        g1 = [c[torch.as_tensor(brp, device=device)].cpu().numpy() for c in pt]
        return cls.from_arrays(
            g1
            + [c[1].cpu().numpy() for c in pt2]
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
