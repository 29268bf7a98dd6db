"""The constants written into the CUDA sources (kateth_tpu_torch/csrc)
equal the ones the Python side computes: moduli and Montgomery constants
as 32-bit limbs, the Frobenius gammas, and |x| of the Miller loop and the
hard part.  The kernels themselves build and run only on a GPU
(chip_smoke.py); this holds their tables here."""

import os
import re

import numpy as np
import pytest

from kateth_tpu_torch import host
from kateth_tpu_torch.fields import fp12
from kateth_tpu_torch.fields import limbs as L

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "kateth_tpu_torch", "csrc")


def _read(name: str) -> str:
    with open(os.path.join(CSRC, name)) as f:
        return f.read()


def _array(src: str, name: str) -> list[int]:
    """The initializer of `__constant__ uint32_t name[...] = {...};`."""
    m = re.search(name + r"(?:\[\d+\])+\s*=\s*(\{.*?\});", src, re.S)
    assert m, name
    return [int(v, 16) for v in re.findall(r"0x([0-9a-fA-F]+)u", m.group(1))]


def _limbs(v: int, n: int) -> list[int]:
    return [(v >> (32 * i)) & 0xFFFFFFFF for i in range(n)]


@pytest.mark.parametrize(
    "prefix,modulus,n",
    [("FR", host.R, 8), ("FP", host.P, 12)],
    ids=["fr", "fp"],
)
def test_field_constants(prefix, modulus, n):
    src = _read("field.cuh")
    assert _array(src, f"{prefix}_MOD") == _limbs(modulus, n)
    assert _array(src, f"{prefix}_ONE") == _limbs((1 << (32 * n)) % modulus, n)
    n0 = int(re.search(rf"{prefix}_N0 = 0x([0-9a-f]+)u", src).group(1), 16)
    assert n0 == (-pow(modulus, -1, 1 << 32)) % (1 << 32)


def test_frobenius_gammas():
    want = []
    for g in fp12.GAMMA:  # (5, 2, 24) Montgomery digits
        for c in g:
            want += _limbs(L.digits_to_int(c), 12)
    assert _array(_read("tower.cuh"), "FP_GAMMA") == want
    assert np.array_equal(fp12.GAMMA[2][0], fp12.GAMMA[2][1])  # gamma_3 = c (1 + u)


@pytest.mark.parametrize("name", ["miller.cu", "hard_part.cu"])
def test_x_abs(name):
    m = re.search(r"kXAbs = 0x([0-9a-f]+)ull", _read(name))
    assert int(m.group(1), 16) == -host.BLS_X
