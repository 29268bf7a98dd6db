"""Library configuration: the sizes of the setup, the batch quantum and
the commitment MSM's parameters."""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class KzgConfig:
    #: field elements per blob (power of two)
    n: int = 4096
    #: number of G2 monomial points in the setup (only [tau]_2 is used)
    g2_len: int = 65
    #: window width in bits of the windowed Pippenger commit (comb_h = 0)
    msm_window: int = 8
    #: comb width h of the fixed-base commit: 2^h precomputed rows per
    #: setup point (at mainnet, h = 12: a 6.4 GB table of int64 digit
    #: planes, built on the device at the first commit); 0 selects the
    #: windowed Pippenger instead
    comb_h: int = 12
    #: canonical batch quantum: a batch of at least this many pads up to a
    #: multiple of it, a smaller one to the next power of two (capped at
    #: it), with weight-0, zero-blob, generator-point lanes, so the device
    #: path sees a fixed set of shapes; commits, proofs and validations
    #: run in programs of at most this many items
    canon_batch: int = 64

    def __post_init__(self):
        if self.n <= 0 or self.n & (self.n - 1):
            raise ValueError("n must be a power of two")
        if self.g2_len < 2:
            raise ValueError("the setup needs at least [1]_2 and [tau]_2")
        if self.canon_batch <= 0:
            raise ValueError("canon_batch must be positive")
        if not 1 <= self.msm_window <= 16:
            raise ValueError("msm_window must be in 1..16")
        if self.comb_h < 0:
            raise ValueError("comb_h must be >= 0")

    @property
    def bytes_per_blob(self) -> int:
        return 32 * self.n


MAINNET = KzgConfig()
