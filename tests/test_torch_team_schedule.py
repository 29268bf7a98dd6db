"""The round schedules of the team kernels K3 (G1 ladder), K4 (Miller
loop), K5 (hard part), K6 (G2 ladder), K7 (chain prefix sums) and K8 (comb
chain sum), kateth_tpu_torch/csrc/schedule_{g1,miller,hard_part,g2,prefix,
comb}.cuh, on the CPU.

The kernels are small interpreters over these tables, so a wrong slot or
a wrong formula shows here: the committed headers are what the generator
emits now, and the tables, run round by round with the plain Fp operations
of kateth_tpu_torch.fields.limbs, give the plain ladder's, the plain
Miller loop's, the plain hard part's, the plain chain sums', the plain
chain prefix sums' and the plain G2 ladder's digits bit for bit.  No
JAX."""

import os

import numpy as np
import pytest
import torch

from kateth_tpu_torch import cuda_pairing, host
from kateth_tpu_torch import team_schedule as gs
from kateth_tpu_torch.curves import g1 as g1mod
from kateth_tpu_torch.curves import g2 as g2mod
from kateth_tpu_torch.curves import cuda_msm, ops
from kateth_tpu_torch.fields import cuda_mont, fp12
from kateth_tpu_torch.fields import limbs as L
from kateth_tpu_torch.fields.specs import FP, FR

@pytest.fixture(autouse=True)
def one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _rounds(prog: gs.Program) -> list:
    """Each round's instructions as index tensors, one group per opcode."""
    out = []
    for _, ins in prog.rounds:
        op, dst, a, b = (torch.tensor(c) for c in zip(*ins))
        out.append([(k, dst[op == k], a[op == k], b[op == k]) for k in op.unique().tolist()])
    return out


def _run(rounds: list, slots: torch.Tensor, bit=None) -> None:
    """Run a program on the slot file (slots, lanes, 24) in place, as the
    kernels do: every operand of a round is read before it writes, and
    each opcode of a round is one batched plain Fp operation."""
    for groups in rounds:
        writes = []
        for op, dst, a, b in groups:
            x = slots[a]
            if op == gs.MUL:
                v = L.mont_mul(FP, x, slots[b])
            elif op == gs.ADD:
                v = L.add(FP, x, slots[b])
            elif op == gs.SUB:
                v = L.sub(FP, x, slots[b])
            elif op == gs.SMALL:
                v = L.mul_small(FP, x, b.numpy()[:, None])
            elif op == gs.COPY:
                v = x
            else:
                v = torch.where(bit[None, :, None], x, slots[b])
            writes.append((dst, v))
        for dst, v in writes:
            slots[dst] = v


def _slots(sched: gs.Schedule, lanes: int, values: dict) -> torch.Tensor:
    slots = torch.zeros(sched.n_slots, lanes, FP.n_digits, dtype=torch.int64)
    slots[sched.slot_of["one"]] = FP.tensor("one_mont", "cpu")
    for name, v in values.items():
        slots[sched.slot_of[name]] = v
    return slots


@pytest.mark.parametrize("fname", sorted(gs.HEADERS))
def test_committed_header_is_generated(fname):
    with open(os.path.join(gs.CSRC, fname)) as f:
        assert f.read() == gs.emit(gs.HEADERS[fname]())


@pytest.mark.parametrize(
    "make",
    [gs.g1_schedule, gs.miller_schedule, gs.hard_part_schedule, gs.comb_schedule, gs.g2_schedule,
     gs.prefix_schedule],
    ids=["g1", "miller", "hard_part", "comb", "g2", "prefix"])
def test_product_rounds_fit_the_team(make):
    """Every product round fits the team, so a round is one product deep
    (building the schedule has already run the generator's hazard
    checks)."""
    s = make()
    for p in s.programs:
        assert max((len(ins) for m, ins in p.rounds if m), default=0) <= s.threads


def test_g1_schedule_matches_plain_ladder():
    """256 ladder steps of the schedule, with scalars 0, r and a random one,
    against cuda_mont.g1_scalar_mul_plain: the same projective digits."""
    rng = np.random.default_rng(0x6731)
    pts = [host.jac_mul_raw(host.FP_OPS, host.G1_GEN, int(k)) for k in rng.integers(1, 1 << 62, 3)]
    P = tuple(torch.as_tensor(c) for c in g1mod.from_ints(pts))
    scalars = [0, host.R, int.from_bytes(rng.bytes(32), "big") % host.R]
    sc = torch.as_tensor(np.stack([L.int_to_digits(s, FR.n_digits) for s in scalars]))
    want = cuda_mont.g1_scalar_mul_plain(P, sc)

    sched = gs.g1_schedule()
    (prog,) = sched.programs
    # acc = (0 : 1 : 0), the base P
    slots = _slots(sched, 3, {"y": FP.tensor("one_mont", "cpu"), "bx": P[0], "by": P[1], "bz": P[2]})
    rounds = _rounds(prog)
    for bit in ops.scalar_bits_msb(sc, 256):
        _run(rounds, slots, bit)
    for n, w in zip(gs.G1_STATE, want):
        assert torch.equal(slots[sched.slot_of[n]], w)


def test_g2_schedule_matches_plain_ladder():
    """64 ladder steps of the G2 schedule against the plain ladder
    ops.scalar_mul(FP2_FIELD, ..., n_bits=64) (which g2_scalar_mul_plain
    runs over 256 bits: every step is the same code): the same projective
    digits.  Bases: a random point, the generator and the point at
    infinity; 64-bit scalars 0, 1, 2^64 - 1 and a random one, on every
    base (12 lanes), so the identity is doubled while the leading bits are
    zero and the infinity is added to itself."""
    rng = np.random.default_rng(0x6732)
    pts = [host.jac_mul_raw(host.FP2_OPS, host.G2_GEN, int(rng.integers(1, 1 << 62))),
           host.G2_GEN, host.jac_infinity(host.FP2_OPS)]
    base = tuple(torch.as_tensor(np.repeat(c, 4, axis=0)) for c in g2mod.from_ints(pts))
    scalars = [0, 1, (1 << 64) - 1, int(rng.integers(0, 1 << 63)) * 2 + 1]
    sc = torch.as_tensor(np.stack([L.int_to_digits(s, FR.n_digits) for s in scalars * 3]))
    want = ops.scalar_mul(ops.FP2_FIELD, base, sc, n_bits=64)
    assert ops.is_identity(ops.FP2_FIELD, base)[8:].all()

    sched = gs.g2_schedule()
    (prog,) = sched.programs
    # acc = (0 : 1 : 0), the base
    values = {"y_0": FP.tensor("one_mont", "cpu")}
    for stem, c in zip(("bx", "by", "bz"), base):
        values[f"{stem}_0"], values[f"{stem}_1"] = c[:, 0], c[:, 1]
    slots = _slots(sched, 12, values)
    rounds = _rounds(prog)
    for bit in ops.scalar_bits_msb(sc, 64):
        _run(rounds, slots, bit)
    for i, n in enumerate(gs.G2_STATE):
        assert torch.equal(slots[sched.slot_of[n]], want[i // 2][:, i % 2]), n


def test_miller_schedule_matches_plain_miller_loop():
    """The 63 steps over the bits of |x|, then the conjugate, against
    cuda_pairing.miller_loop_affine_plain on two lanes: the same Fp12
    digits."""
    rng = np.random.default_rng(0x4D69)
    pts = [host.jac_mul_raw(host.FP_OPS, host.G1_GEN, int(k)) for k in rng.integers(1, 1 << 62, 2)]
    xp, yp = ops.to_affine(ops.FP_FIELD, tuple(torch.as_tensor(c) for c in g1mod.from_ints(pts)))
    q2 = [host.jac_mul_raw(host.FP2_OPS, host.G2_GEN, int(k)) for k in rng.integers(1, 1 << 62, 2)]
    xq, yq = ops.to_affine(ops.FP2_FIELD, tuple(torch.as_tensor(c) for c in g2mod.from_ints(q2)))
    want = cuda_pairing.miller_loop_affine_plain(xp, yp, xq, yq)

    sched = gs.miller_schedule()
    # T = (xq : yq : 1), f = 1 (the other inputs start at zero)
    one = FP.tensor("one_mont", "cpu")
    values = {"xp": xp, "yp": yp, "tz_0": one, "f_0": one}
    for stem, v in (("xq", xq), ("yq", yq), ("tx", xq), ("ty", yq)):
        values[f"{stem}_0"], values[f"{stem}_1"] = v[:, 0], v[:, 1]
    slots = _slots(sched, 2, values)
    rounds = [_rounds(p) for p in sched.programs]
    for bit in bin(cuda_pairing.X_ABS)[3:]:
        _run(rounds[int(bit)], slots)
    f = slots[[sched.slot_of[f"f_{m}"] for m in range(12)]]
    f = torch.cat([f[:6], L.neg(FP, f[6:])])  # the conjugate
    assert torch.equal(f.movedim(0, 1).reshape(2, 2, 3, 2, FP.n_digits), want)


def test_hard_part_schedule_matches_plain_hard_part():
    """The five |x|-powers of the schedule (sqr or sqr_mul per bit of |x|
    after its leading one, then a glue program) against
    cuda_pairing.hard_part_plain on two lanes of cyclotomic elements (random
    Fp12 values through the easy part): the same Fp12 digits."""
    rng = np.random.default_rng(0x4850)
    d = rng.integers(0, 1 << 16, (2, 2, 3, 2, FP.n_digits), dtype=np.int64)
    d[..., -1] = rng.integers(0, int(FP.mod_digits[-1]), d.shape[:-1])
    f = torch.as_tensor(d)
    f = fp12.mul(fp12.conj(f), fp12.inv(f))  # f^(p^6 - 1)
    f = fp12.mul(fp12.frob(fp12.frob(f)), f)  # ^(p^2 + 1)
    want = cuda_pairing.hard_part_plain(f)

    sched = gs.hard_part_schedule()
    coeffs = f.reshape(2, 12, FP.n_digits)  # coefficient m = (w 3 + v) 2 + u
    values = {n: torch.as_tensor(L.int_to_digits(v, FP.n_digits)) for n, v in sched.consts.items()}
    for stem in ("acc", "g", "f"):
        values.update({f"{stem}_{m}": coeffs[:, m] for m in range(12)})
    slots = _slots(sched, 2, values)
    rounds = {p.name: _rounds(p) for p in sched.programs}
    for k in range(5):
        for bit in bin(cuda_pairing.X_ABS)[3:]:
            _run(rounds["sqr_mul" if bit == "1" else "sqr"], slots)
        _run(rounds[f"glue{k}"], slots)
    got = slots[[sched.slot_of[f"acc_{m}"] for m in range(12)]]
    assert torch.equal(got.movedim(0, 1).reshape(want.shape), want)


def test_comb_schedule_matches_plain_chain_sum():
    """The schedule over the rows of three chains of 8, each row's flag the
    lane bit, against cuda_msm.comb_chain_sum_plain: the same projective
    digits.  One chain has clear flags, one only identity rows, and a
    point repeats (the doubling case of the complete addition)."""
    rng = np.random.default_rng(0x636F)
    pts = [host.jac_mul_raw(host.FP_OPS, host.G1_GEN, int(k)) for k in rng.integers(1, 1 << 62, 5)]
    aff = [host.jac_to_affine(host.FP_OPS, p) for p in pts]
    rows = rng.integers(0, 5, (3, 8))
    rows[0, 3] = rows[0, 2]
    flags = rng.random((3, 8)) > 0.3
    flags[1] = False
    x = torch.as_tensor(np.stack([[FP.from_int(aff[r][0]) if f else np.zeros(FP.n_digits, np.int64)
                                   for r, f in zip(rr, ff)] for rr, ff in zip(rows, flags)]))
    y = torch.as_tensor(np.stack([[FP.from_int(aff[r][1]) if f else np.asarray(FP.one_mont)
                                   for r, f in zip(rr, ff)] for rr, ff in zip(rows, flags)]))
    flags = torch.as_tensor(flags)
    want = cuda_msm.comb_chain_sum_plain(x, y, flags, 8)  # (3, 1, 24) each

    sched = gs.comb_schedule()
    slots = _slots(sched, 3, {"y": FP.tensor("one_mont", "cpu")})  # acc = (0 : 1 : 0)
    rounds = _rounds(sched.programs[0])
    for k in range(8):
        slots[sched.slot_of["x2"]], slots[sched.slot_of["y2"]] = x[:, k], y[:, k]
        _run(rounds, slots, flags[:, k])
    for n, w in zip(gs.G1_STATE, want):
        assert torch.equal(slots[sched.slot_of[n]], w[:, 0])


def test_prefix_schedule_matches_plain_chain_prefix():
    """The schedule over the rows of three chains of 8, the running sum read
    after every row, against cuda_msm.chain_prefix_plain: the same
    projective digits.  The rows are projective with random Z; among them
    the identity (0 : 1 : 0), a point repeated (the doubling case of the
    complete addition) and a point followed by its negation."""
    rng = np.random.default_rng(0x7072)
    pts = [host.jac_mul_raw(host.FP_OPS, host.G1_GEN, int(k)) for k in rng.integers(1, 1 << 62, 4)]
    base = tuple(torch.as_tensor(c) for c in g1mod.from_ints([*pts, host.jac_infinity(host.FP_OPS)]))
    neg = ops.pneg(ops.FP_FIELD, base)
    ident = 4
    # (point, negated) per row
    chains = [[(0, 0), (1, 0), (1, 0), (ident, 0), (2, 0), (2, 1), (3, 0), (0, 0)],
              [(ident, 0), (ident, 0), (0, 0), (0, 1), (0, 0), (0, 0), (3, 1), (ident, 0)],
              [(k % 4, k % 3 == 0) for k in range(8)]]
    rows = [[(neg if n else base)[i][p] for p, n in ch] for i in range(3) for ch in chains]
    P = tuple(torch.stack([torch.stack(rows[3 * i + c]) for c in range(3)]) for i in range(3))
    lam = torch.as_tensor(np.stack([FP.from_int(int(v)) for v in rng.integers(1, 1 << 62, 24)]))
    P = tuple(L.mont_mul(FP, c, lam.reshape(3, 8, FP.n_digits)) for c in P)  # (3, 8, 24) each
    want = cuda_msm.chain_prefix_plain(P, 8)

    sched = gs.prefix_schedule()
    slots = _slots(sched, 3, {"y": FP.tensor("one_mont", "cpu")})  # acc = (0 : 1 : 0)
    rounds = _rounds(sched.programs[0])
    for k in range(8):
        for n, c in zip(("x2", "y2", "z2"), P):
            slots[sched.slot_of[n]] = c[:, k]
        _run(rounds, slots)
        for n, w in zip(gs.G1_STATE, want):
            assert torch.equal(slots[sched.slot_of[n]], w[:, k]), (n, k)
