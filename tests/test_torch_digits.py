"""The port's digit extraction (curves/msm.py window_digits, bit_fields;
curves/comb.py column_digits) bit for bit against the JAX package's plain
jnp functions, on seeded random digit planes and on planes of 0, of r - 1
and of all-0xFFFF digits (the last pins the bit-255 edges: window_digits
drops bit 255, column_digits keeps bits below min(h d, 256)); and, under a
TorchDispatchMode, that no tensor the extraction allocates holds more
elements than twice its output (no plane of single bits)."""

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

import jax.numpy as jnp
from kateth_tpu.curves import comb as jcomb
from kateth_tpu.curves import msm as jmsm
from kateth_tpu.oracle import field as of
from kateth_tpu_torch.curves import comb, msm
from kateth_tpu_torch.fields import limbs as L


@pytest.fixture(autouse=True)
def one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def digit_planes() -> np.ndarray:
    """(3, 6, 16) int64 digit planes: 15 random 256-bit values, then 0,
    r - 1 and 2^256 - 1 (every digit 0xFFFF)."""
    rng = np.random.default_rng(0xD161)
    rand = rng.integers(0, 1 << 16, (15, 16), dtype=np.int64)
    edges = np.stack([L.int_to_digits(v, 16) for v in (0, of.R - 1, (1 << 256) - 1)])
    return np.concatenate([rand, edges]).reshape(3, 6, 16)


class Allocations(TorchDispatchMode):
    """Records the largest element count of a tensor that an operation
    returns in new storage (views and in-place results share their
    input's)."""

    def __init__(self):
        super().__init__()
        self.largest = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        seen = {t.untyped_storage().data_ptr() for t in tree_leaves((args, kwargs))
                if isinstance(t, torch.Tensor)}
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor) and t.untyped_storage().data_ptr() not in seen:
                self.largest = max(self.largest, t.numel())
        return out


def check(got_fn, want: np.ndarray) -> None:
    with Allocations() as mode:
        got = got_fn()
    assert got.dtype == torch.int64
    assert np.array_equal(got.numpy(), want.astype(np.int64))
    assert mode.largest <= 2 * got.numel(), (mode.largest, got.numel())


@pytest.mark.parametrize("c", [1, 2, 3, 5, 8, 13, 16])
def test_window_digits_match_jax(c):
    sc = digit_planes()
    want = np.asarray(jmsm.window_digits(jnp.asarray(sc.astype(np.uint32)), c))
    check(lambda: msm.window_digits(torch.as_tensor(sc), c), want)


@pytest.mark.parametrize("h", [1, 4, 5, 12, 15, 16])
def test_column_digits_match_jax(h):
    sc = digit_planes()
    d = comb.comb_dims(h)
    want = np.asarray(jcomb.column_digits(jnp.asarray(sc.astype(np.uint32)), h, d))
    check(lambda: comb.column_digits(torch.as_tensor(sc), h, d), want)


def test_window_start_is_the_windows_msb_first_and_padded():
    """msm.window_start's digits: window_digits, most significant window
    first, with zero digits for the padding points."""
    sc = torch.as_tensor(digit_planes())
    _, digits = msm.window_start(sc, 8, 5)
    want = torch.nn.functional.pad(msm.window_digits(sc, 5), (0, 2)).flip(0)
    assert torch.equal(digits, want) and digits.is_contiguous()
