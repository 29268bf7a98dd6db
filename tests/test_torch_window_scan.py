"""The windowed commit and proof (comb_h = 0) as protocol.Scan programs, the
form in which graphs.py captures them on the card: a head, one window step
replayed W times, and a tail, the port's counterpart of the JAX package's
commit_msm and its lax.scan over the windows (kateth_tpu/kzg/protocol.py
:160, kateth_tpu/curves/msm.py:254-266).

On the CPU at n = 8 with the setup of tests/test_torch_prove.py (comb_h = 0,
msm_window = 8, so W = 32 windows), head, then W step calls in order, then
tail give exactly what protocol.commit_chunk and protocol.prove_chunk give
with protocol.commit_msm bound: the same output tensors, dtype and digits,
so the tolerance is exact equality.  Every kernel runs its plain version
(K7's included).  tests/test_torch_msm.py holds msm.msm against the JAX
package and the oracle, and tests/test_torch_prove_msm.py the Kzg's
windowed commit and proofs, which run these scans, against the oracle.
"""

import functools
import random

import numpy as np
import pytest
import torch

import test_torch_prove as base
from kateth_tpu.oracle import field as of
from kateth_tpu.oracle.kzg import blob_to_bytes
from kateth_tpu_torch.kzg import protocol
from test_torch_prove import arrays, one_thread, osetup  # noqa: F401 (fixtures)

N = 8


def run_scan(scan: protocol.Scan, *inputs):
    """head, then the step once a window in order, then tail."""
    carry, xs, extras = scan.head(*inputs)
    assert xs.shape[0] == 32  # ceil(255 / 8) windows
    for w in range(xs.shape[0]):
        carry = scan.step(carry, xs[w])
    return scan.tail(carry, *extras)


@pytest.mark.parametrize("name", ["commit", "prove"])
def test_scan_equals_eager_program(arrays, osetup, name):
    """Two blobs, the second with a non-canonical element (its ok flag is
    False); the proof at a random z and at the root w_3 (the quotient's
    special row)."""
    rng = random.Random(0x5CA7)
    kzg = base.make_kzg(arrays, 0)
    blobs = [blob_to_bytes([rng.randrange(of.R) for _ in range(N)]) for _ in range(2)]
    blobs[1] = b"\xff" * 32 + blobs[1][32:]
    rows = protocol.to_device([np.frombuffer(b"".join(blobs), dtype=np.uint8).reshape(2, -1)],
                              "cpu")[0]
    scan, _ = kzg._program(name)
    assert isinstance(scan, protocol.Scan)
    setup = kzg.setup
    commit = functools.partial(protocol.commit_msm, setup.g1_points, window=8)
    if name == "commit":
        inputs = (rows,)
        want = protocol.commit_chunk(rows, commit=commit)
    else:
        z = protocol.fr_planes([rng.randrange(of.R), osetup.roots_brp[3]], "cpu")
        inputs = (rows, z)
        want = protocol.prove_chunk(rows, z, setup.roots, setup.inv_roots, commit=commit)
    got = run_scan(scan, *inputs)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
    assert want[0].tolist() == [True, False]
