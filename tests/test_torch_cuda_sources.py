"""The constants written into the CUDA sources (kateth_tpu_torch/csrc)
equal the ones the Python side computes: moduli and Montgomery constants
as 32-bit limbs, the Frobenius gammas, |x| of the Miller loop and the hard
part, the curve constant 3b of the team kernels' schedules (the G1 and
G2 ones), K2's chain limits; every C launcher's parameters match the ctypes types cuda_lib binds it with, and the build's
hash covers the sources.
The kernels themselves build and run only on a GPU (chip_smoke.py); this
holds their tables and interfaces here."""

import os
import re
import shutil

import numpy as np
import pytest

from kateth_tpu_torch import cuda_lib, host
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
    """The hard part's Frobenius constants: named constant slots of
    schedule_hard_part.cuh, whose limbs the kernel loads from kConstLimbs.
    Slot gamma{i}_{c} holds coefficient c of gamma_i, and the slots hold
    every nonzero coefficient's value once."""
    src = _read("schedule_hard_part.cuh")
    rows = _array(src, "kConstLimbs")
    const0 = int(re.search(r"kConst0 = (\d+);", src).group(1))
    slots = {(int(i), int(c)): int(s)
             for i, c, s in re.findall(r"kSlot_gamma(\d)_(\d) = (\d+);", src)}
    assert len(rows) == 12 * len(slots)
    held = set()
    for (i, c), slot in slots.items():
        v = L.digits_to_int(fp12.GAMMA[i - 1][c])  # (5, 2, 24) Montgomery digits
        assert rows[12 * (slot - const0) : 12 * (slot - const0 + 1)] == _limbs(v, 12), (i, c)
        held.add(v)
    assert held == {L.digits_to_int(c) for g in fp12.GAMMA for c in g} - {0}
    assert len(held) == len(slots)
    assert np.array_equal(fp12.GAMMA[2][0], fp12.GAMMA[2][1])  # gamma_3 = c (1 + u)


@pytest.mark.parametrize("name", ["miller.cu", "hard_part.cu"])
def test_x_abs(name):
    m = re.search(r"kXAbs = 0x([0-9a-f]+)ull", _read(name))
    assert int(m.group(1), 16) == -host.BLS_X


def test_curve_constant_3b():
    """b = 4: G1 formulas multiply by 3b = 12, as curves/ops.py: the chain
    prefix kernel's traced addition (schedule_prefix.cuh) multiplies by
    12 alone.  G2 ones by 3b' = 12 xi, and 36 xi = 3 (3b') in the
    doubling: the G2 ladder's traced schedule (schedule_g2.cuh) multiplies
    by exactly 12, 36 and 8 (8 Y^2); each 12 and 36 takes both components
    of xi v = (v0 - v1) + (v0 + v1) u for one Fp2 value v (pdouble's
    12 xi Z^2 and 36 xi Z^2, padd's 12 xi Z1 Z2 and 12 xi of its Y3 term:
    three values by 12, one by 36), and the 8 no xi."""
    from kateth_tpu_torch import team_schedule as gs

    (prog,) = gs.prefix_schedule().programs
    assert {k for _, ins in prog.rounds for op, _, _, k in ins if op == gs.SMALL} == {12}
    (prog,) = gs.g2_schedule().programs
    ks = {k for _, ins in prog.rounds for op, _, _, k in ins if op == gs.SMALL}
    assert ks == {12, 36, 8}
    g, _ = gs.g2_step()
    operands = {}  # k -> the (op, v0, v1) nodes it multiplies
    for op, a, k in g.nodes:
        if op == gs.SMALL:
            operands.setdefault(k, []).append(g.nodes[a])
    for k, n_values in ((12, 3), (36, 1)):
        xi = {(a, b) for op, a, b in operands[k] if op == gs.SUB}
        assert len(xi) == n_values, k
        assert sorted(operands[k]) == sorted(
            x for a, b in xi for x in ((gs.SUB, a, b), (gs.ADD, min(a, b), max(a, b))))
    (op, a, b), other = operands[8]  # 8 Y^2: not a xi pair
    assert other != (gs.ADD, min(a, b), max(a, b))


def test_schedule_constants():
    """The team kernels' schedules (team_schedule.py traces curves/ops.py)
    carry 3b: b = 4 on G1, so the G1 ladder's small multiples are 3b and
    3 (3b) (pdouble's b3 Z^2 and 3 b3 Z^2, padd's b3 Z1 Z2) and 8 (8 Y^2)."""
    from kateth_tpu_torch import team_schedule as gs

    b = host.FP_OPS.b
    assert b == 4 and host.FP2_OPS.b == (4, 4)
    (prog,) = gs.g1_schedule().programs
    ks = {k for _, ins in prog.rounds for op, _, _, k in ins if op == gs.SMALL}
    assert ks == {3 * b, 9 * b, 8}


def test_pow_chain_limits():
    """K2's chain fits pow_team.cuh: its steps in kPowMaxSteps, its odd
    powers (windows of at most POW_MAX_WINDOW bits) in kPowMaxTable."""
    from kateth_tpu_torch.fields import cuda_mont

    src = _read("pow_team.cuh")
    steps = int(re.search(r"kPowMaxSteps = (\d+);", src).group(1))
    table = int(re.search(r"kPowMaxTable = (\d+);", src).group(1))
    assert steps == cuda_mont.POW_MAX_STEPS
    assert table == 1 << (cuda_mont.POW_MAX_WINDOW - 1)


def test_source_hash_covers_only_cuda_sources(tmp_path, monkeypatch):
    """Bytecode or a script beside the sources (a csrc/__pycache__) neither
    breaks the build's hash nor changes it; an edited header does."""
    want = cuda_lib.source_hash()
    csrc = tmp_path / "csrc"
    shutil.copytree(cuda_lib.CSRC, csrc)
    (csrc / "__pycache__").mkdir(exist_ok=True)
    (csrc / "__pycache__" / "notes.cpython-312.pyc").write_bytes(b"\0")
    (csrc / "notes.py").write_text("")
    monkeypatch.setattr(cuda_lib, "CSRC", str(csrc))
    assert cuda_lib.source_hash() == want
    with open(csrc / "team.cuh", "a") as f:
        f.write("\n")
    assert cuda_lib.source_hash() != want


_CTYPES = {"ptr": cuda_lib._P, "int": cuda_lib._I, "int64_t": cuda_lib._L}


def _c_params(src: str, fn: str) -> list:
    m = re.search(r"\bint " + fn + r"\(([^)]*)\)\s*\{", src)
    assert m, fn
    kinds = []
    for param in m.group(1).split(","):
        decl = param.strip().rsplit(" ", 1)[0]
        kinds.append("ptr" if "*" in param else decl)
    return [_CTYPES[k] for k in kinds]


@pytest.mark.parametrize("kernel", sorted(cuda_lib.KERNELS))
def test_launcher_signature_matches_binding(kernel):
    """The ctypes argument types, then the stream, are the C launcher's."""
    lib, fn, argtypes = cuda_lib.KERNELS[kernel]
    src = _read(cuda_lib.LIBRARIES[lib])
    assert 'extern "C"' in src and "kateth_error_string" in src
    assert _c_params(src, fn) == [*argtypes, cuda_lib._P]
