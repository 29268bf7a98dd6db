"""G2 (the twist, over Fp2) on digit planes: the converter from host
Jacobian Fp2 triples (kateth_tpu_torch.host) and the generator."""

from __future__ import annotations

import numpy as np
import torch

from .. import host
from ..fields import fp2
from ..fields import limbs as L
from . import ops

F = ops.FP2_FIELD


def from_ints(points) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Host Jacobian G2 points -> projective (X, Y, Z) digit planes
    (n, 2, 24), Z = 1 (or the identity (0 : 1 : 0))."""
    xs, ys, zs = [], [], []
    for pt in points:
        aff = host.jac_to_affine(host.FP2_OPS, pt)
        x, y, z = ((0, 0), (1, 0), (0, 0)) if aff is None else (aff[0], aff[1], (1, 0))
        xs.append(fp2.from_ints(*x))
        ys.append(fp2.from_ints(*y))
        zs.append(fp2.from_ints(*z))
    return np.stack(xs), np.stack(ys), np.stack(zs)


#: the generator as projective digit planes (2, 24) each
GENERATOR = tuple(c[0] for c in from_ints([host.G2_GEN]))
_GENERATOR = L.DeviceConstants(lambda i: GENERATOR[i])


def generator(device) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """GENERATOR on `device`, made once per device."""
    return tuple(_GENERATOR.get(i, device) for i in range(3))
