"""The port's device programs read nothing back to the host and upload no
constant twice: the two properties that let graphs.py capture each of them
as one CUDA graph, held on the CPU.

protocol.verify_blob_batch_fused and pairing_check run on one batch of the
known-secret setup of tests/test_torch_kzg.py (n = 8, 3 blobs and a pad
lane) three times:

1. plainly, which also puts every constant on the device (the CPU);
2. under a TorchDispatchMode that raises on every operation that reads a
   tensor's value on the host (aten._local_scalar_dense, item, is_nonzero,
   nonzero, equal): on a CUDA device each would wait for the device;
3. with torch.as_tensor, torch.tensor and torch.from_numpy made to raise, so
   no constant is built from host data again.

Runs 2 and 3 must finish and give the first run's outputs bit for bit.
The other four programs of graphs.py's cache, protocol.verify_kzg,
validate_g1, commit_chunk and prove_chunk (with the comb commit bound as
Kzg._program binds it, over a table of random rows), go through the same
three runs on inputs of the same setup, and so do the parts of the
windowed commit and proof (comb_h = 0, protocol.commit_scan and
prove_scan), each of which graphs.py captures as a graph of its own: the
two heads, the window step and the two tails, at msm_window = 2 (one step
of 2 doublings and 3 bucket boundaries).

On a CUDA device the wrappers of K2-K8 are one kernel launch each, which
reads nothing back.  Their plain versions, which only the CPU runs, repeat
the kernels' arithmetic over thousands of steps (about 9 s of the 9.5 s of
a plain run on the CPU), so in these runs stand-ins take their place: each
returns a fresh tensor of the kernel's output shape, a cheap function of
its inputs.  K1 keeps its plain version, the digit convolution and the
Montgomery reduction of fields/limbs.py, and every limbs operation runs
under the mode once more on its own.  tests/test_torch_kzg.py holds the
full plain run against the oracle.
"""

import random

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from kateth_tpu.kzg import DeviceSetup
from kateth_tpu.kzg import KzgConfig as JaxKzgConfig
from kateth_tpu.oracle import field as of
from kateth_tpu.oracle.kzg import OracleSetup, blob_to_bytes
from kateth_tpu_torch import cuda_pairing
from kateth_tpu_torch.curves import cuda_msm
from kateth_tpu_torch.fields import cuda_mont
from kateth_tpu_torch.fields import limbs as L
from kateth_tpu_torch.fields.specs import FP, FR
from kateth_tpu_torch.kzg import Kzg, KzgConfig, TorchSetup
from kateth_tpu_torch.kzg import protocol
from kateth_tpu_torch.kzg.setup import FIELDS

N = 8
aten = torch.ops.aten

#: the operations that read a tensor's value on the host
HOST_READS = {aten._local_scalar_dense, aten.item, aten.is_nonzero, aten.nonzero, aten.equal}


class NoHostReads(TorchDispatchMode):
    """Raises on any operation of HOST_READS."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.overloadpacket in HOST_READS:
            raise AssertionError(f"the program reads a tensor on the host: {func}")
        return func(*args, **(kwargs or {}))


@pytest.fixture(autouse=True)
def one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def pow_stand_in(spec, a, e):
    return L.add(spec, a, a)


def ladder_stand_in(point, scalar_digits):
    batch = torch.broadcast_shapes(scalar_digits.shape[:-1], *(c.shape[:-1] for c in point))
    s = torch.cat([scalar_digits, scalar_digits[..., :8]], -1).expand(*batch, FP.n_digits)
    return tuple(L.add(FP, c.expand(*batch, FP.n_digits), s) for c in point)


def miller_stand_in(xp, yp, xq, yq):
    f6 = torch.stack([L.add(FP, xp[..., None, :], xq), L.add(FP, yp[..., None, :], yq), xq], -3)
    return torch.stack([f6, f6], -4)  # (..., 2, 3, 2, 24)


def hard_part_stand_in(f):
    return L.add(FP, f, f)


def g2_ladder_stand_in(point, scalar_digits):
    batch = torch.broadcast_shapes(scalar_digits.shape[:-1], *(c.shape[:-2] for c in point))
    s = torch.cat([scalar_digits, scalar_digits[..., :8]], -1)[..., None, :]
    return tuple(L.add(FP, c.expand(*batch, 2, FP.n_digits), s.expand(*batch, 2, FP.n_digits))
                 for c in point)


def chain_prefix_stand_in(p, g):
    return tuple(L.add(FP, c, c) for c in p)


def comb_chain_stand_in(x, y, flags, g=cuda_msm.COMB_CHAIN):
    """The first row of each chain of g rows, mixed with its y and flag."""
    x0, y0 = (c.reshape(*c.shape[:-2], -1, g, FP.n_digits)[..., 0, :] for c in (x, y))
    f0 = flags.reshape(*flags.shape[:-1], -1, g)[..., :1].bool()
    return L.add(FP, x0, y0), L.add(FP, y0, y0), torch.where(f0, x0, y0)


@pytest.fixture(scope="module")
def stand_ins():
    """K2-K8's wrappers replaced by cheap stand-ins for the module's
    tests."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(cuda_mont, "pow_const", pow_stand_in)
        mp.setattr(cuda_mont, "g1_scalar_mul", ladder_stand_in)
        mp.setattr(cuda_pairing, "miller_loop_affine", miller_stand_in)
        mp.setattr(cuda_pairing, "hard_part", hard_part_stand_in)
        mp.setattr(cuda_pairing, "g2_scalar_mul", g2_ladder_stand_in)
        mp.setattr(cuda_msm, "chain_prefix", chain_prefix_stand_in)
        mp.setattr(cuda_msm, "comb_chain_sum", comb_chain_stand_in)
        yield


@pytest.fixture(scope="module")
def batch(stand_ins):
    """The staged arguments of one batch, and its outputs from a plain run."""
    rng = random.Random(0x5F1C)
    osetup = OracleSetup.generate_insecure(N, g2_len=2)
    jax_setup = DeviceSetup.from_oracle(osetup, JaxKzgConfig(n=N, g2_len=2))
    arrays = [np.asarray(getattr(jax_setup, k)) for k in FIELDS]
    kzg = Kzg(TorchSetup.from_arrays(arrays, KzgConfig(n=N, g2_len=2, canon_batch=4), "cpu"))
    blobs = [blob_to_bytes([rng.randrange(of.R) for _ in range(N)]) for _ in range(3)]
    cms = [osetup.blob_to_commitment(b) for b in blobs]
    proofs = [osetup.blob_proof(b, c) for b, c in zip(blobs, cms)]
    _, args = kzg._verify_batch_stage(blobs, cms, proofs)
    return args, run(args)


def run(args):
    """verify_blob_batch_fused, then pairing_check: every output tensor."""
    pc_in, packed = protocol.verify_blob_batch_fused(*args)
    verdict = protocol.pairing_check(*pc_in)
    return [verdict, packed, *(c for pt in pc_in for c in pt)]


def assert_same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)


def test_plain_run_shapes(batch):
    _, (verdict, packed, *pc_in) = batch
    assert verdict.shape == (1,) and verdict.dtype == torch.bool
    assert packed.shape == (7, 4)
    assert bool(packed[[0, 1, 4]].all())  # canonical blobs, valid encodings
    assert [tuple(c.shape) for c in pc_in] == [(1, 24)] * 3 + [(1, 2, 24)] * 3 + [(1, 24)] * 3


@pytest.mark.parametrize("field", ["fr", "fp"])
def test_limbs_ops_no_host_reads(field):
    """Every fields/limbs.py operation, its plain Montgomery product and
    power included, under the mode: the same digits as without it."""
    spec = {"fr": FR, "fp": FP}[field]
    rng = np.random.default_rng(11)
    d = rng.integers(0, 1 << 16, (2, 8, spec.n_digits), dtype=np.int64)
    d[..., -1] %= int(spec.mod_digits[-1])
    d[0, 0] = spec.mod_digits - np.eye(1, spec.n_digits, 0, dtype=np.int64)[0]  # N - 1
    d[0, 1] = 0
    a, b = torch.as_tensor(d[0]), torch.as_tensor(d[1])
    ks = np.array([12, 36, 8, 1, 3, 127, 2, 5]).reshape(8, 1)

    def ops():
        return [
            L.add(spec, a, b), L.sub(spec, a, b), L.neg(spec, a), L.cond_sub_mod(spec, a),
            cuda_mont.mont_mul_plain(spec, a, b), L.to_mont(spec, a), L.from_mont(spec, a),
            L.mul_small(spec, a, 12), L.mul_small(spec, a, ks), L.lt_modulus(spec, a),
            L.sum_mod(spec, a), L.batch_inv(spec, a), cuda_mont.pow_const_plain(spec, a, 11),
        ]

    want = ops()
    with NoHostReads():
        got = ops()
    assert_same(got, want)


def test_no_host_reads(batch):
    args, want = batch
    with NoHostReads():
        got = run(args)
    assert_same(got, want)


def test_constants_are_made_once(batch, monkeypatch):
    args, want = batch

    def refuse(*_, **__):
        raise AssertionError("a constant was built from host data again")

    for name in ("as_tensor", "tensor", "from_numpy"):
        monkeypatch.setattr(torch, name, refuse)
    got = run(args)
    monkeypatch.undo()
    assert_same(got, want)


# --- single-point verify, validation, commit and prove -----------------------

PROGRAMS = ("verify_kzg", "validate_g1", "commit", "prove")


@pytest.fixture(scope="module")
def programs(stand_ins):
    """Each program's bound function (Kzg._program), its inputs on a setup
    of n = 8 with a batch quantum of 4 and comb_h = 4, and its outputs
    from a plain run.  The comb table is random rows: the values do not
    matter here, only that each run gives the same ones."""
    rng = random.Random(0x9A7B)
    osetup = OracleSetup.generate_insecure(N, g2_len=2)
    jax_setup = DeviceSetup.from_oracle(osetup, JaxKzgConfig(n=N, g2_len=2))
    arrays = [np.asarray(getattr(jax_setup, k)) for k in FIELDS]
    cfg = KzgConfig(n=N, g2_len=2, canon_batch=4, comb_h=4)
    kzg = Kzg(TorchSetup.from_arrays(arrays, cfg, "cpu"))
    gen = np.random.default_rng(0x9A7B)
    kzg._comb_table = tuple(torch.as_tensor(gen.integers(0, 1 << 16, (N << 4, FP.n_digits)))
                            for _ in range(2))
    blobs = [blob_to_bytes([rng.randrange(of.R) for _ in range(N)]) for _ in range(3)]
    cms = [osetup.blob_to_commitment(b) for b in blobs]
    z = of.fr_to_be_bytes(rng.randrange(of.R))
    proof, y = osetup.proof(blobs[0], z)

    def rows(data: bytes, width: int):
        return np.frombuffer(data, dtype=np.uint8).reshape(-1, width)

    blob_rows = rows(b"".join(blobs) + bytes(32 * N), 32 * N)
    z_vals = [int.from_bytes(z, "big"), rng.randrange(of.R), 0, 0]
    inputs = {
        "verify_kzg": protocol.to_device([
            rows(proof, 48), rows(cms[0], 48), protocol.fr_planes_host([z_vals[0]]),
            protocol.fr_planes_host([int.from_bytes(y, "big")])], "cpu"),
        "validate_g1": protocol.to_device([rows(b"".join(cms) + cms[0], 48)], "cpu"),
        "commit": protocol.to_device([blob_rows], "cpu"),
        "prove": protocol.to_device([blob_rows, protocol.fr_planes_host(z_vals)], "cpu"),
    }
    out = {}
    for name in PROGRAMS:
        fn = kzg._program(name)[0]
        out[name] = fn, inputs[name], list(fn(*inputs[name]))
    return out


def test_program_plain_run_shapes(programs):
    shapes = {name: [(tuple(t.shape), t.dtype) for t in want]
              for name, (_, _, want) in programs.items()}
    assert shapes == {
        "verify_kzg": [((1,), torch.bool), ((6, 1), torch.bool)],
        "validate_g1": [((3, 4), torch.bool)],
        "commit": [((4,), torch.bool), ((4, 48), torch.uint8)],
        "prove": [((4,), torch.bool), ((4, 16), torch.int64), ((4, 48), torch.uint8)],
    }
    assert bool(programs["commit"][2][0].all()) and bool(programs["prove"][2][0].all())
    assert bool(programs["verify_kzg"][2][1][[0, 3]].all())  # encodings


@pytest.mark.parametrize("name", PROGRAMS)
def test_program_no_host_reads(programs, name):
    fn, inputs, want = programs[name]
    with NoHostReads():
        got = list(fn(*inputs))
    assert_same(got, want)


@pytest.mark.parametrize("name", PROGRAMS)
def test_program_constants_are_made_once(programs, name, monkeypatch):
    fn, inputs, want = programs[name]

    def refuse(*_, **__):
        raise AssertionError("a constant was built from host data again")

    for attr in ("as_tensor", "tensor", "from_numpy"):
        monkeypatch.setattr(torch, attr, refuse)
    got = list(fn(*inputs))
    monkeypatch.undo()
    assert_same(got, want)


# --- the windowed commit and proof: heads, window step, tails ----------------

SCAN_PARTS = ("commit head", "prove head", "window step", "commit tail", "prove tail")


@pytest.fixture(scope="module")
def scan_parts(stand_ins):
    """Each part of the windowed scans (Kzg._program at comb_h = 0, a
    window of 2 bits) as a function of its inputs returning a flat list of
    tensors, its inputs and its outputs from a plain run.  The step takes a
    carry one step past the identity and a middle window's digits."""
    rng = random.Random(0x57E9)
    osetup = OracleSetup.generate_insecure(N, g2_len=2)
    jax_setup = DeviceSetup.from_oracle(osetup, JaxKzgConfig(n=N, g2_len=2))
    arrays = [np.asarray(getattr(jax_setup, k)) for k in FIELDS]
    cfg = KzgConfig(n=N, g2_len=2, canon_batch=4, comb_h=0, msm_window=2)
    kzg = Kzg(TorchSetup.from_arrays(arrays, cfg, "cpu"))
    commit, prove = kzg._program("commit")[0], kzg._program("prove")[0]
    blobs = [blob_to_bytes([rng.randrange(of.R) for _ in range(N)]) for _ in range(3)]
    rows = np.frombuffer(b"".join(blobs) + bytes(32 * N), dtype=np.uint8).reshape(4, -1)
    z = protocol.fr_planes_host([rng.randrange(of.R) for _ in range(4)])
    blob_rows, z = protocol.to_device([rows, z], "cpu")
    carry, xs, (ok,) = commit.head(blob_rows)
    _, _, (_, y) = prove.head(blob_rows, z)
    w = xs.shape[0] // 2
    carry = commit.step(carry, xs[w - 1])

    def flat(out):
        return [t for x in out for t in (x if isinstance(x, tuple) else (x,))]

    parts = {
        "commit head": (lambda *a: flat(commit.head(*a)), (blob_rows,)),
        "prove head": (lambda *a: flat(prove.head(*a)), (blob_rows, z)),
        "window step": (lambda *a: list(commit.step(tuple(a[:3]), a[3])), (*carry, xs[w])),
        "commit tail": (lambda *a: list(commit.tail(tuple(a[:3]), *a[3:])), (*carry, ok)),
        "prove tail": (lambda *a: list(prove.tail(tuple(a[:3]), *a[3:])), (*carry, ok, y)),
    }
    return {name: (fn, inputs, fn(*inputs)) for name, (fn, inputs) in parts.items()}


def test_scan_parts_plain_run_shapes(scan_parts):
    shapes = {name: [(tuple(t.shape), t.dtype) for t in want]
              for name, (_, _, want) in scan_parts.items()}
    point = [((4, 24), torch.int64)] * 3
    assert shapes == {
        "commit head": point + [((128, 4, N), torch.int64), ((4,), torch.bool)],
        "prove head": point + [((128, 4, N), torch.int64), ((4,), torch.bool),
                               ((4, 16), torch.int64)],
        "window step": point,
        "commit tail": [((4,), torch.bool), ((4, 48), torch.uint8)],
        "prove tail": [((4,), torch.bool), ((4, 16), torch.int64), ((4, 48), torch.uint8)],
    }


@pytest.mark.parametrize("name", SCAN_PARTS)
def test_scan_part_no_host_reads(scan_parts, name):
    fn, inputs, want = scan_parts[name]
    with NoHostReads():
        got = fn(*inputs)
    assert_same(got, want)


@pytest.mark.parametrize("name", SCAN_PARTS)
def test_scan_part_constants_are_made_once(scan_parts, name, monkeypatch):
    fn, inputs, want = scan_parts[name]

    def refuse(*_, **__):
        raise AssertionError("a constant was built from host data again")

    for attr in ("as_tensor", "tensor", "from_numpy"):
        monkeypatch.setattr(torch, attr, refuse)
    got = fn(*inputs)
    monkeypatch.undo()
    assert_same(got, want)


def test_window_step_matches_the_full_prefix_scan(scan_parts, monkeypatch):
    """The window step, whose two-level scan adds the chain offsets at the
    2^c - 1 bucket boundaries and the last point alone, gives bit for bit
    the step that gathers those sums from the full prefix scan."""
    scan = cuda_msm.prefix_scan_kernel

    def full_then_gather(p, idx):
        every = torch.arange(p[0].shape[-2]).expand(p[0].shape[:-1])
        return tuple(torch.take_along_dim(a, idx[..., None], dim=-2) for a in scan(p, every))

    fn, inputs, want = scan_parts["window step"]
    monkeypatch.setattr(cuda_msm, "prefix_scan_kernel", full_then_gather)
    assert_same(fn(*inputs), want)
