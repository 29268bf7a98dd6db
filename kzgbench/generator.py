"""The one traffic generator: it reads a traffic file's parameters and
makes, from a seed, the pool of inputs with the reference's expected
results, and the calls a window makes.

A traffic file (kzgbench/traffic/<name>.json) names the entry it drives,
the loop that drives it and their parameters:

* "entry": the file kzgbench/entries/<entry>.py, whose class Entry makes
  the pool and draws, runs and judges a call (its docstring gives its
  parameters);
* "loop": the file kzgbench/loops/<loop>.py, whose drive() makes the
  window's calls;
* "warmup_calls" calls of their own stream run in the set-up;
  "trace_seconds" bounds a traced window.

A later mix adds a traffic file, and an entry or a loop as a file of its
own; it edits none that is there.  Every pool, call and expectation
comes from the seed and the plain reference alone (kzgbench/reference):
nothing the program made."""

from __future__ import annotations

import importlib
from dataclasses import dataclass

import numpy as np

from .reference.fields import R
from .reference.kzg import KnownTau, blob_scalars, compute_challenge

#: streams of a seed: the pool, the window's calls, the warm-up's calls
POOL, CALLS, WARMUP = 0, 1, 2


def rng_for(seed: int, *stream: int) -> np.random.Generator:
    return np.random.default_rng([seed % (1 << 64), *stream])


@dataclass
class Call:
    """One call: its arguments, what the judge needs, the items it carries
    ({"proofs": n} or {"blobs": n}) and the operations it counts as."""

    args: tuple
    picks: object
    items: dict
    ops: int
    outputs: object = None
    error: str | None = None
    start: float = 0.0
    end: float = 0.0


def random_blobs(rng: np.random.Generator, count: int, n: int) -> list[bytes]:
    """Blobs of canonical elements: 32 random bytes each, the top two bits
    cleared (below 2^254 < r)."""
    raw = rng.integers(0, 256, size=(count, n, 32), dtype=np.uint8)
    raw[:, :, 0] &= 0x3F
    return [raw[i].tobytes() for i in range(count)]


def random_fr(rng: np.random.Generator, count: int) -> list[int]:
    raw = rng.integers(0, 256, size=(count, 32), dtype=np.uint8)
    return [int.from_bytes(raw[i].tobytes(), "big") % R for i in range(count)]


class BlobPool:
    """`size` valid (blob, commitment, proof) triples and their scalars."""

    def __init__(self, size: int, ref: KnownTau, base, rng):
        n = ref.domain.n
        self.blobs = random_blobs(rng, size, n)
        elements = [blob_scalars(b) for b in self.blobs]
        self.c = [ref.commitment(f) for f in elements]
        self.commitments = base.compress_many(self.c)
        self.z = [compute_challenge(b, comm, n) for b, comm in zip(self.blobs, self.commitments)]
        self.y = [ref.domain.evaluate(f, z) for f, z in zip(elements, self.z)]
        self.pi = [ref.proof(c, z, y) for c, z, y in zip(self.c, self.z, self.y)]
        self.proofs = base.compress_many(self.pi)


def entry(name: str):
    """The class Entry of kzgbench/entries/<name>.py."""
    return importlib.import_module(f"{__package__}.entries.{name}").Entry


def loop(name: str):
    """The module kzgbench/loops/<name>.py."""
    return importlib.import_module(f"{__package__}.loops.{name}")


class Traffic:
    """A traffic file's calls for one seed: warm-up calls, then the
    window's, each drawn from a stream of its own, so the k-th call is
    the same whatever the window reaches."""

    def __init__(self, params: dict, seed: int, ref: KnownTau, base):
        self.params, self.seed = params, seed
        self.entry = entry(params["entry"])(params, ref, base, rng_for(seed, POOL))
        self.loop = loop(params["loop"])

    def warmup(self):
        for k in range(self.params.get("warmup_calls", 1)):
            yield self.entry.draw(rng_for(self.seed, WARMUP, k))

    def calls(self):
        """The window's calls, k = 0, 1, ..."""
        k = 0
        while True:
            yield self.entry.draw(rng_for(self.seed, CALLS, k))
            k += 1
