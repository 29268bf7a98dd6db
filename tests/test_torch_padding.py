"""The port's padding rule (Kzg._canon) and the programs it sizes
(Kzg._chunks), in pure Python: a batch of at least canon_batch items pads
to a multiple of canon_batch, a smaller one to the next power of two capped
at canon_batch; commits, proofs and validations run in programs of at most
canon_batch items, and Kzg.lanes counts the lanes given and run."""

import pytest
import torch

from kateth_tpu_torch.kzg import Kzg, KzgConfig, TorchSetup

N = 8

#: n -> the padded size at canon_batch 64 and at canon_batch 48
PADDED = {
    0: (1, 1), 1: (1, 1), 2: (2, 2), 3: (4, 4), 5: (8, 8), 6: (8, 8), 8: (8, 8), 9: (16, 16),
    33: (64, 48), 63: (64, 96), 64: (64, 96), 65: (128, 96), 128: (128, 144), 192: (192, 192),
}


def make_kzg(canon_batch: int) -> Kzg:
    """A Kzg on a setup of zero planes: nothing here runs a program."""
    planes = [torch.zeros(rows, d, dtype=torch.int64)
              for rows, d in ((N, 24),) * 3 + ((2, 24),) * 3 + ((N, 16),) * 2]
    return Kzg(TorchSetup.from_arrays(planes, KzgConfig(n=N, g2_len=2, canon_batch=canon_batch),
                                      "cpu"))


@pytest.mark.parametrize("canon_batch", [64, 48])
@pytest.mark.parametrize("n", sorted(PADDED))
def test_padding_rule(n, canon_batch):
    kzg = make_kzg(canon_batch)
    padded = PADDED[n][canon_batch == 48]
    assert kzg._canon(n) == padded
    size, starts = kzg._chunks("commit", n)
    # one program of the padded size below canon_batch, else programs of
    # canon_batch items, the last one padded
    assert size == (padded if n < canon_batch else canon_batch)
    assert list(starts) == list(range(0, n, size))
    assert len(starts) * size == (padded if n else 0)
    assert kzg.lanes == ({"commit": [n, padded]} if n else {})
    kzg._chunks("commit", n)
    kzg._chunks("prove", n)
    assert kzg.lanes == ({"commit": [2 * n, 2 * padded], "prove": [n, padded]} if n else {})
