"""The byte-level KZG operations: commitments, proofs, single-point and
batch blob-proof verification, and the conversion of blobs to monomial
coefficients and back.

Invalid encodings, non-canonical field elements and off-curve or
out-of-subgroup points raise KzgError; `False` is returned only for an
honest verification failure.  The host prefix (length checks, SHA-256
Fiat-Shamir challenges, the batch challenge r and its weights) runs in
Python; the rest runs on the setup's device.  Every batched operation pads
its batch (zero blobs, generator points): below config.canon_batch to the
next power of two, from it on to a multiple of it (Kzg._canon), so the
device sees a fixed set of shapes and a small batch runs on few lanes.
Host data reaches a CUDA device by asynchronous copies from pinned memory.

Each operation's device work is one program of kzg/protocol.py a batch,
or a chunk of canon_batch blobs: verify_blob_batch, verify_kzg,
validate_g1, commit_chunk and prove_chunk (with the windowed commit,
comb_h = 0: commit_scan and prove_scan).  On a CUDA device each runs as
CUDA graphs of this Kzg's graph cache (graphs.py), captured at the first
call of its batch size and replayed after: one graph a program, or for a
scan a head, a step replayed once a window and a tail.  The outputs of all
of an operation's programs are read back in one copy, and the errors are
raised from them in the JAX package's order.  The batch verification's
dispatch never waits for the device, so streaming overlaps a batch's host
prefix with the device work of the batches before it.  CPU tensors run the
same programs eagerly.
"""

from __future__ import annotations

import functools
import hashlib
import threading

import numpy as np
import torch

from .. import graphs, host, ntt
from ..curves import compress, comb
from ..fields.specs import FR
from ..host import KzgError
from . import protocol
from .config import MAINNET, KzgConfig
from .setup import DEFAULT_CACHE_DIR, TorchSetup

BYTES_PER_FIELD_ELEMENT = 32
BYTES_PER_COMMITMENT = 48
BYTES_PER_PROOF = 48

#: the compressed G1 generator: the always-valid pad point of a batch
_G1_GEN_BYTES = host.g1_compress(host.G1_GEN)


class Kzg:
    """The library handle: a trusted setup on one device."""

    def __init__(self, setup: TorchSetup):
        self.setup = setup
        self.config = setup.config
        self.device = setup.device
        #: the fixed-base comb table, built at the first commit (6.4 GB on
        #: the card at mainnet), never for a caller who only verifies
        self._comb_table = None
        self._table_lock = threading.Lock()
        #: the CUDA graphs of this setup's device programs (None on the CPU,
        #: which runs the programs eagerly), batch verify's among them
        cuda = self.device.type == "cuda"
        self._graphs = graphs.GraphCache(self.device) if cuda else None
        self._verify_graphs = (graphs.VerifyBatchGraphs(setup.roots, setup.tau2, self._graphs)
                               if cuda else None)
        #: the padding's count, by program name ("verify_batch", "commit",
        #: "prove", "validate_g1"): [lanes given, lanes run], summed over
        #: the calls since construction
        self.lanes: dict[str, list[int]] = {}
        self._lanes_lock = threading.Lock()

    @classmethod
    def load_json(
        cls, path: str, config: KzgConfig = MAINNET, device=None,
        cache_dir: str | None = DEFAULT_CACHE_DIR,
    ) -> "Kzg":
        """Load a trusted-setup JSON onto `device`: CUDA by default, and an
        error when there is no CUDA device unless the caller names one."""
        return cls(TorchSetup.load_json(path, config, device, cache_dir))

    def _canon(self, n: int) -> int:
        """The padded batch size of n items: from config.canon_batch on, the
        next multiple of it; below it, the next power of two (1 for n = 0),
        capped at canon_batch.  So a block's 6 blobs run on 8 lanes."""
        cb = self.config.canon_batch
        if n >= cb:
            return cb * -(-n // cb)
        return min(1 << (max(n, 1) - 1).bit_length(), cb)

    def _count_lanes(self, name: str, given: int, run: int) -> None:
        with self._lanes_lock:
            counts = self.lanes.setdefault(name, [0, 0])
            counts[0] += given
            counts[1] += run

    def _challenge_digests(self, joined_blobs: bytes, joined_comms: bytes, n: int):
        """Per-blob Fiat-Shamir digests H(domain || n || blob_i || comm_i)."""
        prefix = host.FS_DOMAIN + self.config.n.to_bytes(16, "big")
        nb = self.config.bytes_per_blob
        return [
            hashlib.sha256(
                prefix + joined_blobs[i * nb : (i + 1) * nb] + joined_comms[i * 48 : (i + 1) * 48]
            ).digest()
            for i in range(n)
        ]

    def _rlc_challenge(self, z_digests, joined_comms: bytes, joined_proofs: bytes, n: int) -> int:
        """The batch challenge r: it binds every input, the blobs through
        their fixed-width challenge digests, so predictable weights cannot
        let two invalid triples cancel."""
        return host.hash_to_fr(
            host.RC_DOMAIN
            + self.config.n.to_bytes(16, "big")
            + n.to_bytes(16, "big")
            + b"".join(z_digests)
            + joined_comms
            + joined_proofs
        )

    # -- host codecs ----------------------------------------------------------

    def _to_device(self, data: bytes, width: int) -> torch.Tensor:
        return protocol.to_device([np.frombuffer(data, dtype=np.uint8).reshape(-1, width)],
                                  self.device)[0]

    def _blob_rows(self, blobs, rows: int) -> np.ndarray:
        """Blobs of checked lengths as a (rows, bytes_per_blob) uint8 host
        array, zero blobs padding it."""
        nb = self.config.bytes_per_blob
        joined = b"".join(bytes(b) for b in blobs) + bytes(nb * (rows - len(blobs)))
        return np.frombuffer(joined, dtype=np.uint8).reshape(rows, nb)

    def _check_blob_lengths(self, blobs) -> None:
        nbytes = self.config.bytes_per_blob
        for b in blobs:
            if len(b) != nbytes:
                raise KzgError("invalid blob length")

    def _decode_blobs(self, blobs, pad_to: int | None = None):
        """list[bytes] -> (plain element planes (B, N, 16), ok (B,)) on the
        device.  Length errors raise here; canonicality comes back as a
        mask.  With pad_to, zero blobs pad the batch; callers slice [:n]."""
        self._check_blob_lengths(blobs)
        rows = self._blob_rows(blobs, max(len(blobs), pad_to or 0))
        return protocol.decode_blobs(protocol.to_device([rows], self.device)[0])

    @staticmethod
    def _check_ok(ok) -> None:
        """ok: a tensor or a read-back array of canonicality flags."""
        if not bool(ok.all()):
            raise KzgError("non-canonical field element in blob")

    @staticmethod
    def _fr_bytes_to_int(b: bytes) -> int:
        if len(b) != BYTES_PER_FIELD_ELEMENT:
            raise KzgError("invalid field element length")
        v = int.from_bytes(bytes(b), "big")
        if v >= host.R:
            raise KzgError("non-canonical field element")
        return v

    def _challenges(self, blobs, commitments) -> list[int]:
        """Fiat-Shamir challenges of (blob, commitment) pairs, mod r."""
        digests = self._challenge_digests(
            b"".join(bytes(b) for b in blobs), b"".join(bytes(c) for c in commitments), len(blobs)
        )
        return [int.from_bytes(d, "big") % host.R for d in digests]

    # -- device programs --------------------------------------------------------

    def _chunks(self, name: str, n: int) -> tuple[int, range]:
        """(size, starts) of the device programs `name` of an n-item commit,
        proof or validation: one program of the padded batch size below
        config.canon_batch items, else programs of canon_batch items (the
        last one padded); each takes `size` items from its start.  Counts
        the lanes (Kzg.lanes)."""
        size = min(self._canon(n), self.config.canon_batch)
        starts = range(0, n, size)
        if n:
            self._count_lanes(name, n, len(starts) * size)
        return size, starts

    def _table(self):
        """The comb table, built at the first call."""
        with self._table_lock:
            if self._comb_table is None:
                self._comb_table = comb.build_table(self.setup.g1_points, self.config.comb_h)
        return self._comb_table

    def _program(self, name: str):
        """(fn, held) of program `name`: the protocol program with this
        setup's tensors bound, and the tensors it reads by address.  The
        windowed commit and proof (comb_h = 0) are protocol.Scan programs
        over the windows, as the JAX package's lax.scan; the others are
        functions of tensors."""
        setup, cfg = self.setup, self.config
        if name == "verify_kzg":
            return functools.partial(protocol.verify_kzg, tau2=setup.tau2), setup.tau2
        if name == "validate_g1":
            return protocol.validate_g1, ()
        if cfg.comb_h == 0:
            if name == "commit":
                return protocol.commit_scan(setup.g1_points, cfg.msm_window), setup.g1_points
            return (protocol.prove_scan(setup.g1_points, setup.roots, setup.inv_roots, cfg.msm_window),
                    (setup.g1_points, setup.roots, setup.inv_roots))
        table = self._table()
        commit = functools.partial(protocol.commit_comb, table, h=cfg.comb_h, n=cfg.n)
        if name == "commit":
            return functools.partial(protocol.commit_chunk, commit=commit), table
        return (functools.partial(protocol.prove_chunk, roots=setup.roots,
                                  inv_roots=setup.inv_roots, commit=commit),
                (setup.roots, setup.inv_roots, table))

    def _run(self, name: str, inputs):
        """Program `name` on `inputs`: on CUDA the replay of its graphs in
        this Kzg's cache (captured at the first call of the batch size), on
        the CPU an eager call.  The outputs are not read back."""
        fn, held = self._program(name)
        if self._graphs is None:
            return fn(*inputs)
        return self._graphs.program(name, fn, held)(inputs)

    @staticmethod
    def _read_back(tensors) -> list[np.ndarray]:
        """Device tensors -> numpy arrays of their shapes and dtypes, in one
        copy to the host."""
        flat = [t.contiguous().view(torch.uint8).reshape(-1) for t in tensors]
        raw = torch.cat(flat).cpu().numpy()
        out, o = [], 0
        for t, f in zip(tensors, flat):
            dtype = np.dtype(str(t.dtype).removeprefix("torch."))
            out.append(raw[o:o + f.numel()].view(dtype).reshape(t.shape))
            o += f.numel()
        return out

    # -- commitments and proofs ------------------------------------------------

    def blob_to_kzg_commitment(self, blob: bytes) -> bytes:
        return self.blobs_to_kzg_commitments([blob])[0]

    def _commit_dispatch(self, blobs):
        """Host checks and the commit programs, one a chunk; returns the
        (ok, commitment bytes) pair of each chunk, not yet read back."""
        self._check_blob_lengths(blobs)
        size, starts = self._chunks("commit", len(blobs))
        if not starts:
            return []
        (rows,) = protocol.to_device([self._blob_rows(blobs, len(starts) * size)], self.device)
        return [self._run("commit", (rows[i:i + size],)) for i in starts]

    def blobs_to_kzg_commitments(self, blobs) -> list[bytes]:
        n = len(blobs)
        outs = self._commit_dispatch(blobs)
        if not outs:
            return []
        ok, raw = self._read_back([torch.cat([o[k] for o in outs])[:n] for k in range(2)])
        self._check_ok(ok)
        return compress.rows_to_bytes(raw)

    def compute_kzg_proof(self, blob: bytes, z: bytes) -> tuple[bytes, bytes]:
        (proof,), (y,) = self.compute_kzg_proofs([blob], [z])
        return proof, y

    def _prove_dispatch(self, blobs, z_vals):
        """The prove programs of blobs of checked lengths at the points
        z_vals (ints), one a chunk; returns each chunk's (ok, y plain, proof
        bytes), not yet read back."""
        n = len(blobs)
        size, starts = self._chunks("prove", n)
        if not starts:
            return []
        rows = len(starts) * size
        blob_rows, z = protocol.to_device(
            [self._blob_rows(blobs, rows), protocol.fr_planes_host(list(z_vals) + [0] * (rows - n))],
            self.device)
        return [self._run("prove", (blob_rows[i:i + size], z[i:i + size])) for i in starts]

    def compute_kzg_proofs(self, blobs, zs):
        """Proofs of each blob's polynomial at its point z: (proofs, ys),
        lists of bytes.  A blob's errors come before a z's, as in the JAX
        package: a bad z is found on the host, its lane runs with z = 0,
        and its error is raised after the blobs' canonicality is read."""
        if len(blobs) != len(zs):
            raise KzgError("length mismatch")
        self._check_blob_lengths(blobs)
        n = len(blobs)
        z_vals, z_error = [], None
        for z in zs:
            try:
                z_vals.append(self._fr_bytes_to_int(z))
            except KzgError as e:
                z_error = z_error or e
                z_vals.append(0)
        outs = self._prove_dispatch(blobs, z_vals)
        if not outs:
            return [], []
        ok, y, raw = self._read_back([torch.cat([o[k] for o in outs])[:n] for k in range(3)])
        self._check_ok(ok)
        if z_error is not None:
            raise z_error
        ys = [FR.to_int(row, mont=False).to_bytes(32, "big") for row in y]
        return compress.rows_to_bytes(raw), ys

    def compute_blob_kzg_proof(self, blob: bytes, commitment: bytes) -> bytes:
        return self.compute_blob_kzg_proofs([blob], [commitment])[0]

    def _validate_dispatch(self, points):
        """The validate_g1 programs of points of checked lengths, padded
        with generator bytes, one a chunk; returns each chunk's (3, size)
        masks, not yet read back."""
        n = len(points)
        size, starts = self._chunks("validate_g1", n)
        if not starts:
            return []
        joined = b"".join(bytes(p) for p in points) + _G1_GEN_BYTES * (len(starts) * size - n)
        rows = self._to_device(joined, BYTES_PER_COMMITMENT)
        return [self._run("validate_g1", (rows[i:i + size],))[0] for i in starts]

    def compute_blob_kzg_proofs(self, blobs, commitments) -> list[bytes]:
        """Blob proofs: each blob's proof at its Fiat-Shamir challenge.  As
        in the JAX package, the commitments' lengths are checked first, then
        their device masks are raised, and only then the blobs' lengths and
        canonicality: a blob of the wrong length still waits for the
        commitments' masks."""
        if len(blobs) != len(commitments):
            raise KzgError("length mismatch")
        for p in commitments:
            if len(p) != BYTES_PER_COMMITMENT:
                raise KzgError("invalid point length")
        n = len(blobs)
        masks = self._validate_dispatch(commitments)
        try:
            self._check_blob_lengths(blobs)
        except KzgError:
            if masks:
                self._raise_point_masks(self._read_back([torch.cat(masks, 1)[:, :n]])[0])
            raise
        outs = self._prove_dispatch(blobs, self._challenges(blobs, commitments))
        if not outs:
            return []
        m, ok, raw = self._read_back([torch.cat(masks, 1)[:, :n],
                                      *(torch.cat([o[k] for o in outs])[:n] for k in (0, 2))])
        self._raise_point_masks(m)
        self._check_ok(ok)
        return compress.rows_to_bytes(raw)

    # -- polynomial form conversion (the NTT, ntt.py) ----------------------------

    @staticmethod
    def _fr_planes_to_byteslists(plain: torch.Tensor) -> list[list[bytes]]:
        """(B, N, 16) plain digit planes -> per-blob lists of 32-byte
        big-endian scalars, in one read-back and one byte conversion."""
        arr = plain.cpu().numpy()
        raw = arr[..., ::-1].astype(">u2").tobytes()  # most significant digit first
        B, N = arr.shape[:2]
        return [[raw[(b * N + i) * 32 : (b * N + i + 1) * 32] for i in range(N)] for b in range(B)]

    def blobs_to_coefficients(self, blobs) -> list[list[bytes]]:
        """Blobs (evaluations over the bit-reversed roots) -> monomial
        coefficients, ascending degree, 32-byte big-endian each."""
        n = len(blobs)
        elements, ok = self._decode_blobs(blobs, pad_to=self._canon(n))
        self._check_ok(ok[:n])
        cm = ntt.lagrange_brp_to_monomial(protocol.fr_to_mont(elements))
        return self._fr_planes_to_byteslists(protocol.fr_from_mont(cm))[:n]

    def coefficients_to_blobs(self, coeffs) -> list[bytes]:
        """Monomial coefficients (per-blob lists of 32-byte big-endian
        scalars, ascending degree) -> blobs.  A wrong count or a
        non-canonical coefficient raises KzgError."""
        for cs in coeffs:
            if len(cs) != self.config.n:
                raise KzgError("invalid coefficient count")
        joined = [b"".join(bytes(c) for c in cs) for cs in coeffs]
        n = len(joined)
        elements, ok = self._decode_blobs(joined, pad_to=self._canon(n))
        self._check_ok(ok[:n])
        ev = ntt.monomial_to_lagrange_brp(protocol.fr_to_mont(elements))
        return [b"".join(cs) for cs in self._fr_planes_to_byteslists(protocol.fr_from_mont(ev))[:n]]

    # -- verification -------------------------------------------------------

    def _verify_kzg_dispatch(self, proof: bytes, commitment: bytes, z: bytes, y: bytes):
        """Host checks and the verify_kzg program: (verdict, packed masks),
        not yet read back."""
        for b in (proof, commitment):
            if len(b) != BYTES_PER_COMMITMENT:
                raise KzgError("invalid point length")
        z_v = self._fr_bytes_to_int(z)
        y_v = self._fr_bytes_to_int(y)
        staged = protocol.to_device([
            np.frombuffer(bytes(proof), dtype=np.uint8).reshape(1, BYTES_PER_PROOF),
            np.frombuffer(bytes(commitment), dtype=np.uint8).reshape(1, BYTES_PER_COMMITMENT),
            protocol.fr_planes_host([z_v]), protocol.fr_planes_host([y_v]),
        ], self.device)
        return self._run("verify_kzg", staged)

    def verify_kzg_proof(self, proof: bytes, commitment: bytes, z: bytes, y: bytes) -> bool:
        """Single-point verification: e(proof, [tau]_2 - z G2) ==
        e(C - y G1, G2).  The proof's errors are raised before the
        commitment's."""
        verdict, masks = self._read_back(self._verify_kzg_dispatch(proof, commitment, z, y))
        self._raise_point_masks(masks[:3])
        self._raise_point_masks(masks[3:])
        return bool(verdict[0])

    def verify_blob_kzg_proof(self, blob: bytes, commitment: bytes, proof: bytes) -> bool:
        return self.verify_blob_kzg_proof_batch([blob], [commitment], [proof])

    def verify_blob_kzg_proof_batch(self, blobs, commitments, proofs) -> bool:
        """Random-linear-combination batch verification with weights
        r^0 = 1, r, r^2, ..."""
        return self._verify_batch_finalize(self._verify_batch_dispatch(blobs, commitments, proofs))

    def verify_blob_kzg_proof_batches(self, batches) -> list[bool]:
        """Streaming batch verification: one verdict per (blobs,
        commitments, proofs) triple.  Every batch is dispatched to the
        device before any verdict is read back.  Errors are those a loop of
        verify_blob_kzg_proof_batch calls would raise: the earliest bad
        batch's, found at dispatch (lengths) or at finalize (canonicality,
        point validity), and then no verdicts are returned."""
        pendings = []
        dispatch_error: KzgError | None = None
        for b, c, p in batches:
            try:
                pendings.append(self._verify_batch_dispatch(b, c, p))
            except KzgError as e:
                dispatch_error = e
                break
        verdicts = [self._verify_batch_finalize(p) for p in pendings]
        if dispatch_error is not None:
            raise dispatch_error
        return verdicts

    def _verify_batch_stage(self, blobs, commitments, proofs):
        """Host prefix: validation, Fiat-Shamir, padded device transfers.
        Returns (n, arguments of protocol.verify_blob_batch_fused)."""
        if not (len(blobs) == len(commitments) == len(proofs)):
            raise KzgError("length mismatch")
        n = len(blobs)
        if n == 0:
            return 0, None
        nbytes = self.config.bytes_per_blob
        for b in blobs:
            if len(b) != nbytes:
                raise KzgError("invalid blob length")
        for p in list(commitments) + list(proofs):
            if len(p) != BYTES_PER_COMMITMENT:
                raise KzgError("invalid point length")

        # pad lanes: weight 0, a zero blob (canonical) and generator points
        # (valid, in the subgroup): they add the identity to every lincomb
        nc = self._canon(n)
        pad = nc - n
        self._count_lanes("verify_batch", n, nc)
        joined_blobs = b"".join(bytes(b) for b in blobs)
        joined_comms = b"".join(bytes(c) for c in commitments)
        joined_proofs = b"".join(bytes(p) for p in proofs)

        z_digests = self._challenge_digests(joined_blobs, joined_comms, n)
        z_vals = [int.from_bytes(d, "big") % host.R for d in z_digests] + [0] * pad
        r = self._rlc_challenge(z_digests, joined_comms, joined_proofs, n)
        weights = [pow(r, i, host.R) for i in range(n)] + [0] * pad
        zw = [w * z % host.R for w, z in zip(weights, z_vals)]

        def rows(data: bytes, width: int) -> np.ndarray:
            return np.frombuffer(data, dtype=np.uint8).reshape(nc, width)

        staged = protocol.to_device([
            rows(joined_blobs + b"\x00" * (nbytes * pad), nbytes),
            rows(joined_comms + _G1_GEN_BYTES * pad, BYTES_PER_COMMITMENT),
            rows(joined_proofs + _G1_GEN_BYTES * pad, BYTES_PER_PROOF),
            *(protocol.fr_planes_host(v) for v in (z_vals, zw, weights)),
        ], self.device)
        return n, (*staged, self.setup.roots, self.setup.tau2)

    def _verify_batch_dispatch(self, blobs, commitments, proofs):
        """Host prefix and device work; returns (n, verdict, packed masks)
        with the device results not yet read back.  On CUDA the device work
        is a replay of this padded batch size's graph, captured at its first
        batch; nothing here waits for the device."""
        n, args = self._verify_batch_stage(blobs, commitments, proofs)
        if n == 0:
            return 0, None, None
        if self._verify_graphs is None:
            return n, *protocol.verify_blob_batch(*args)
        return n, *self._verify_graphs(args[:6])

    def _verify_batch_finalize(self, pending) -> bool:
        n, verdict, packed = pending
        if n == 0:
            return True
        m = packed[:, :n].cpu().numpy()  # pad lanes sliced off
        # blob canonicality first, then the commitments, then the proofs
        if not m[0].all():
            raise KzgError("non-canonical field element in blob")
        self._raise_point_masks(m[1:4])
        self._raise_point_masks(m[4:7])
        return bool(verdict)

    @staticmethod
    def _raise_point_masks(masks):
        """(ok_encoding, ok_curve, ok_subgroup) -> KzgError."""
        ok_enc, ok_curve, ok_sub = masks
        if not ok_enc.all():
            raise KzgError("invalid G1 point: BadEncoding")
        if not ok_curve.all():
            raise KzgError("invalid G1 point: NotOnCurve")
        if not ok_sub.all():
            raise KzgError("invalid G1 point: NotInGroup")
