"""G1 on digit planes: the generic complete-formula ops over Fp, and the
converter from host Jacobian int triples (kateth_tpu_torch.host)."""

from __future__ import annotations

import numpy as np
import torch

from .. import host
from ..fields import limbs as L
from ..fields.specs import FP
from . import ops

F = ops.FP_FIELD


def from_ints(points) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Host Jacobian G1 points -> projective (X, Y, Z) digit planes (n, 24),
    Z = 1 (or the identity (0 : 1 : 0))."""
    xs, ys, zs = [], [], []
    for pt in points:
        aff = host.jac_to_affine(host.FP_OPS, pt)
        x, y, z = (0, 1, 0) if aff is None else (aff[0], aff[1], 1)
        xs.append(FP.from_int(x))
        ys.append(FP.from_int(y))
        zs.append(FP.from_int(z))
    return np.stack(xs), np.stack(ys), np.stack(zs)


#: the generator as projective digit planes (24,) each
GENERATOR = tuple(c[0] for c in from_ints([host.G1_GEN]))
_GENERATOR = L.DeviceConstants(lambda i: GENERATOR[i])


def generator(device) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """GENERATOR on `device`, made once per device."""
    return tuple(_GENERATOR.get(i, device) for i in range(3))
