"""Concrete field specs for BLS12-381: Fr in 16 digits (R = 2^256), Fp in
24 digits (R = 2^384)."""

from ..host import P as _P
from ..host import R as _R
from .limbs import FieldSpec

#: Scalar field (order of G1/G2), 255 bits in 16 digits.
FR = FieldSpec(name="fr", modulus=_R, n_digits=16)

#: Base field, 381 bits in 24 digits.
FP = FieldSpec(name="fp", modulus=_P, n_digits=24)
