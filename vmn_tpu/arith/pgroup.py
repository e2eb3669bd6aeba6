"""Prime-order group / ring / field layer over batched limb tensors.

Device-batched rebuild of the VCR `arithm` surface consumed by the mix-net
(reference: SURVEY.md §2.4 — PGroup/PGroupElementArray with `exp`, `mul`,
`expProd`, `permute`, `inv`, `prod`, `shiftPush`; PRing/PField arrays with
`add`, `mulAdd`, `innerProduct`, `sum`, `recLin`, `prods`).

Design
------
* A group-element array is a `GArray`: a ``(..., L)`` uint32 limb tensor in
  Montgomery form plus its owning `ModPGroup`.  The leading axis is the
  ciphertext batch N — it vectorizes over device threads and shards over the
  device mesh; scalars are shape ``(L,)``.
* Field/ring element arrays are `FArray`: standard-form limb tensors over
  the prime field Z_q (exponents).
* Product groups (`PPGroup`) are *pytrees*: nested tuples of `GArray`
  leaves.  A width-w El Gamal ciphertext batch is
  ``PPArray((PPArray(u_1..u_w), PPArray(v_1..v_w)))`` — every leaf is an
  independent (N, L) tensor and XLA fuses across leaves.
* Linear-recurrence ops (`recLin` — reference PoSBasicTW.java:596,
  `prods` — PoSBasicTW.java:604) are log-depth `associative_scan`s over
  affine maps, not sequential loops.

Byte-tree encodings follow the reference conventions: group elements are
fixed-size unsigned big-endian leaves of ``p.bit_length()//8 + 1`` bytes
(Java ``BigInteger.toByteArray`` length for positive p), field elements
likewise over q; arrays are nodes of element leaves.
"""

from __future__ import annotations

import functools
from typing import Iterable, List, Optional, Sequence, Tuple, Union

import jax
import jax.numpy as jnp
import numpy as np

from vmn_tpu.arith.limbs import (
    LIMB_BITS,
    bytes_be_to_limbs,
    int_to_limbs,
    ints_to_limbs,
    limbs_to_bytes_be,
    limbs_to_int,
    limbs_to_ints,
    num_limbs,
)
from vmn_tpu.arith.mont import MontCtx, device_limbs, host_limbs
from vmn_tpu.eio.bytetree import ByteTree, ByteTreeError, int_leaf, leaf, node


def _bytelen(n: int) -> int:
    """Java BigInteger.toByteArray() length for a positive integer n."""
    return n.bit_length() // 8 + 1


# ------------------------------------------------- deferred membership
#
# The standalone verifier overlaps host-side subgroup-membership checks
# (native batch Jacobi, ~1-2 s per 2048-bit N-array on this host's
# cores) with device compute: inside a `deferred_membership` scope,
# `elem_from_bytetree` hands its membership predicate to the collector
# instead of evaluating it inline, and the caller joins the results
# before pronouncing a verdict (rerunning eagerly on any failure, so
# Byzantine-input semantics stay bit-identical to the inline path).

import threading as _threading

_DEFER_TLS = _threading.local()


class deferred_membership:
    """Context manager routing membership checks to `submit(thunk)`.

    `submit` receives zero-arg callables returning bool and must return
    a handle with `.result()` (e.g. concurrent.futures). Thread-local:
    concurrent protocol sessions in other threads are unaffected."""

    def __init__(self, submit):
        self.submit = submit

    def __enter__(self):
        self._prev = getattr(_DEFER_TLS, "hook", None)
        _DEFER_TLS.hook = self.submit
        return self

    def __exit__(self, *exc):
        _DEFER_TLS.hook = self._prev
        return False


def _range_check_be(raw: np.ndarray, p: int, bytelen: int,
                    allow_zero: bool = False) -> bool:
    """Vectorized check that every (bytelen,)-row satisfies 0 < x < p
    (0 <= x < p with allow_zero, for EC coordinates)."""
    pb = np.frombuffer(p.to_bytes(bytelen, "big"), np.uint8)
    # lexicographic big-endian compare row < pb
    diff = raw.astype(np.int16) - pb.astype(np.int16)
    first_nz = (diff != 0).argmax(axis=1)
    rows = np.arange(raw.shape[0])
    lt = diff[rows, first_nz] < 0  # equal rows give diff 0 -> not <
    if allow_zero:
        return bool(lt.all())
    nonzero = raw.any(axis=1)
    return bool((lt & nonzero).all())


# =====================================================================
# Permutation
# =====================================================================


class Permutation:
    """A permutation of {0..n-1} (reference: VCR arithm.Permutation).

    Stored as a host numpy index vector ``tbl`` with ``out[i] = in[tbl[i]]``
    under `GArray.permute` — matching the reference's column semantics
    u = (g^{r} h).permute(pi) with u_i = x_{pi(i)}.
    """

    def __init__(self, tbl: np.ndarray):
        self.tbl = np.asarray(tbl, dtype=np.int64)

    @property
    def size(self) -> int:
        return int(self.tbl.shape[0])

    @staticmethod
    def random(n: int, randomsource) -> "Permutation":
        """Uniform random permutation from a RandomSource.

        Small n: exact Fisher–Yates.  Large n: argsort of 128-bit random
        keys drawn from the source (collision probability < n²/2^128;
        vectorized — the Python Fisher–Yates loop dominated setup time
        at N ≥ 2^16)."""
        if n <= 4096:
            tbl = np.arange(n, dtype=np.int64)
            for i in range(n - 1, 0, -1):
                j = randomsource.random_int_mod(i + 1)
                tbl[i], tbl[j] = tbl[j], tbl[i]
            return Permutation(tbl)
        raw = np.frombuffer(randomsource.read_bytes(16 * n), np.uint64)
        keys = raw.reshape(n, 2)
        order = np.lexsort((keys[:, 1], keys[:, 0]))
        return Permutation(order.astype(np.int64))

    @staticmethod
    def identity(n: int) -> "Permutation":
        return Permutation(np.arange(n, dtype=np.int64))

    def inv(self) -> "Permutation":
        out = np.empty_like(self.tbl)
        out[self.tbl] = np.arange(self.tbl.shape[0], dtype=np.int64)
        return Permutation(out)

    def shrink(self, n: int) -> "Permutation":
        """Restriction keeping relative order of images < n
        (reference: Permutation.shrink used by maxciph shrinking)."""
        keep = self.tbl[self.tbl < n]
        return Permutation(keep)

    def to_bytetree(self) -> ByteTree:
        return node(*[int_leaf(int(i)) for i in self.tbl])

    @staticmethod
    def from_bytetree(bt: ByteTree) -> "Permutation":
        tbl = np.asarray([c.to_u32() for c in bt.children], dtype=np.int64)
        return Permutation(tbl)


# =====================================================================
# Field of exponents  Z_q
# =====================================================================


class PField:
    """Prime field Z_q — the ring of exponents of a prime-order group."""

    def __init__(self, q: int):
        self.q = q
        self.ctx = MontCtx(q)
        self.L = self.ctx.L
        self.bytelen = _bytelen(q)
        self.nbits = q.bit_length()

    # ------------------------------------------------------------ build

    def zeros(self, shape=()) -> "FArray":
        return FArray(self, jnp.zeros(tuple(shape) + (self.L,), jnp.uint32))

    def ones(self, shape=()) -> "FArray":
        one = jnp.asarray(int_to_limbs(1, self.L))
        return FArray(self, jnp.broadcast_to(one, tuple(shape) + (self.L,)))

    def from_ints(self, xs: Sequence[int]) -> "FArray":
        xs = [x % self.q for x in xs]
        return FArray(self, jnp.asarray(ints_to_limbs(xs, self.L)))

    def from_int(self, x: int) -> "FArray":
        return FArray(self, jnp.asarray(int_to_limbs(x % self.q, self.L)))

    def random(self, shape, randomsource, rbitlen: int) -> "FArray":
        """Uniform-ish field elements: (nbits+rbitlen)-bit ints mod q
        (reference: PRing.randomElementArray semantics).

        Vectorized: bulk source bytes -> limb tensor -> batched device
        reduction mod q (no per-element Python bignum arithmetic)."""
        n = int(np.prod(shape)) if shape else 1
        bits = self.nbits + rbitlen
        wide = self.random_bits_raw(n, bits, randomsource)
        arr = self.ctx.reduce_std(wide)
        return FArray(self, arr.reshape(tuple(shape) + (self.L,)))

    def random_bits_raw(self, n: int, bits: int, randomsource):
        """n uniform `bits`-bit integers as (n, Lw) standard limbs."""
        if hasattr(randomsource, "random_limbs"):
            # Device-expanded PRF source (DeviceSource): no bulk
            # host->device upload — ~300 MB saved per full-width draw
            # at N = 2^20.
            limbs = randomsource.random_limbs(n, bits)
            Lw = max(self.L, num_limbs(bits))
            if limbs.shape[1] < Lw:
                import jax.numpy as jnp

                limbs = jnp.pad(
                    limbs, ((0, 0), (0, Lw - limbs.shape[1]))
                )
            return limbs
        nbytes = (bits + 7) // 8
        raw = np.frombuffer(
            randomsource.read_bytes(n * nbytes), np.uint8
        ).reshape(n, nbytes)
        extra = 8 * nbytes - bits
        if extra:
            raw = raw.copy()
            raw[:, 0] &= 0xFF >> extra
        Lw = max(self.L, num_limbs(bits))
        return device_limbs(bytes_be_to_limbs(raw, Lw))

    def random_bits(self, n: int, bits: int, randomsource) -> "FArray":
        """n uniform `bits`-bit integers as field elements, reduced mod q
        when they can exceed it (reference: PoSBasicTW.java:470-474)."""
        raw = self.random_bits_raw(n, bits, randomsource)
        if bits >= self.nbits:
            return FArray(self, self.ctx.reduce_std(raw))
        return FArray(self, raw)

    def random_bits_prg(self, n: int, ebitlen: int, prg) -> "FArray":
        """Batching vector: n integers of exactly `ebitlen` bits from a PRG
        (reference: LargeIntegerArray.random(size, ebitlen, prg) fed into
        pField.unsafeToElementArray, PoSBasicTW.setBatchVector
        PoSBasicTW.java:533-538).  Reduced mod q when ebitlen can exceed
        the field (EC groups: 256-bit batching vectors over a 224-bit
        field)."""
        nbytes = (ebitlen + 7) // 8
        raw = np.frombuffer(prg.read_bytes(n * nbytes), np.uint8).reshape(
            n, nbytes
        )
        extra = 8 * nbytes - ebitlen
        if extra:
            raw = raw.copy()
            raw[:, 0] &= 0xFF >> extra
        if ebitlen >= self.nbits:
            wide = device_limbs(
                bytes_be_to_limbs(raw, max(self.L, num_limbs(ebitlen)))
            )
            return FArray(self, self.ctx.reduce_std(wide))
        return FArray(self, device_limbs(bytes_be_to_limbs(raw, self.L)))

    # --------------------------------------------------------- serialize

    def to_bytetree(self, fa: "FArray") -> ByteTree:
        """Array -> node of fixed-size leaves; scalar -> single leaf."""
        arr = host_limbs(fa.limbs)
        if arr.ndim == 1:
            return leaf(
                limbs_to_bytes_be(arr[None], self.bytelen)[0].tobytes()
            )
        b = limbs_to_bytes_be(arr.reshape(-1, self.L), self.bytelen)
        return node(*[leaf(b[i].tobytes()) for i in range(b.shape[0])])

    def from_bytetree(self, bt: ByteTree, size: Optional[int] = None):
        if bt.is_leaf:
            x = bt.to_int_unsigned()
            if x >= self.q:
                raise ByteTreeError("field element out of range")
            return self.from_int(x)
        if size is not None and len(bt.children) != size:
            raise ByteTreeError("wrong field array length")
        from vmn_tpu.eio.bytetree import parse_uniform_array

        raw = parse_uniform_array(bt)
        if raw is not None and raw.shape[1] == self.bytelen:
            # Vectorized fast path (no per-element Python ints): range
            # check 0 <= x < q lexicographically on the raw bytes.
            qb = np.frombuffer(self.q.to_bytes(self.bytelen, "big"),
                               np.uint8)
            diff = raw.astype(np.int16) - qb.astype(np.int16)
            first_nz = (diff != 0).argmax(axis=1)
            rows = np.arange(raw.shape[0])
            lt = diff[rows, first_nz] < 0
            if not lt.all():
                raise ByteTreeError("field element out of range")
            fa = FArray(self, device_limbs(bytes_be_to_limbs(raw, self.L)))
            fa._bt = bt  # canonical encoding == input; memo the fetch
            return fa
        xs = [c.to_int_unsigned() for c in bt.children]
        if any(x >= self.q for x in xs):
            raise ByteTreeError("field element out of range")
        return FArray(self, jnp.asarray(ints_to_limbs(xs, self.L)))

    def __eq__(self, other):
        return isinstance(other, PField) and other.q == self.q

    def __repr__(self):
        return f"PField({self.nbits} bits)"


class FArray:
    """Array (or scalar) of field elements in standard form."""

    __slots__ = ("field", "limbs", "_bt")

    def spill(self) -> "FArray":
        """Move to the disk-spill backend when arrays=file
        (reference: file-mapped LargeIntegerArray,
        ProtocolElGamal.java:332-345)."""
        from vmn_tpu.arith import storage

        return FArray(self.field, storage.maybe_spill(self.limbs))

    def __init__(self, field: PField, limbs):
        self.field = field
        self.limbs = limbs

    # -------------------------------------------------------------- meta

    @property
    def shape(self):
        return self.limbs.shape[:-1]

    @property
    def size(self) -> int:
        return int(self.limbs.shape[0])

    def __len__(self):
        return self.size

    def get(self, i: int) -> "FArray":
        return FArray(self.field, self.limbs[i])

    def copy_of_range(self, a: int, b: int) -> "FArray":
        return FArray(self.field, self.limbs[a:b])

    def to_ints(self) -> List[int]:
        return limbs_to_ints(np.asarray(self.limbs))

    def to_int(self) -> int:
        assert self.limbs.ndim == 1
        return limbs_to_int(np.asarray(self.limbs))

    # --------------------------------------------------------------- ops

    def _f(self, other) -> "FArray":
        if isinstance(other, FArray):
            return other
        return self.field.from_int(other)

    def add(self, other) -> "FArray":
        o = self._f(other)
        return FArray(self.field, self.field.ctx.add(self.limbs, o.limbs))

    def sub(self, other) -> "FArray":
        o = self._f(other)
        return FArray(self.field, self.field.ctx.sub(self.limbs, o.limbs))

    def neg(self) -> "FArray":
        return FArray(self.field, self.field.ctx.neg(self.limbs))

    def mul(self, other) -> "FArray":
        """Standard-form product: one extra Montgomery conversion."""
        o = self._f(other)
        c = self.field.ctx
        return FArray(self.field, c.mul(c.to_mont(self.limbs), o.limbs))

    def mul_add(self, v: "FArray", t: "FArray") -> "FArray":
        """self * v + t (reference: PRingElement.mulAdd, reply step
        PoSBasicTW.java:873-878)."""
        return self.mul(v).add(t)

    def inv(self) -> "FArray":
        c = self.field.ctx
        return FArray(
            self.field, c.from_mont(c.inv(c.to_mont(self.limbs)))
        )

    def sum(self) -> "FArray":
        """Sum over the leading axis (one compiled tree program)."""
        return FArray(self.field, self.field.ctx.sum(self.limbs, axis=0))

    def prod(self) -> "FArray":
        c = self.field.ctx
        m = c.prod(c.to_mont(self.limbs), axis=0)
        return FArray(self.field, c.from_mont(m))

    def inner_product(self, other: "FArray") -> "FArray":
        return self.mul(other).sum()

    def prods(self) -> "FArray":
        """Cumulative products e_0, e_0e_1, ... (log-depth scan;
        reference: PRingElementArray.prods, PoSBasicTW.java:604)."""
        c = self.field.ctx
        out = c.prods_scan(c.to_mont(self.limbs))
        return FArray(self.field, c.from_mont(out))

    def rec_lin(self, e: "FArray") -> Tuple["FArray", "FArray"]:
        """x_0 = b_0; x_i = x_{i-1} e_i + b_i.  Returns (x, x_{N-1})
        (reference: PRingElementArray.recLin, PoSBasicTW.java:596).

        Log-depth Hillis–Steele over affine maps f_i(t) = m t + a:
        (m1,a1)∘(m2,a2) -> (m1 m2, a1 m2 + a2), one compiled program
        whose products use the Montgomery core on the GPU.
        """
        c = self.field.ctx
        x = c.rec_lin(c.to_mont(e.limbs), self.limbs)
        return FArray(self.field, x), FArray(self.field, x[-1])

    def shift_push(self, first: "FArray") -> "FArray":
        """[first, x_0, ..., x_{N-2}] (reference: shiftPush)."""
        f = jnp.broadcast_to(first.limbs, (1, self.field.L))
        return FArray(
            self.field, jnp.concatenate([f, self.limbs[:-1]], axis=0)
        )

    def permute(self, pi: Permutation) -> "FArray":
        return FArray(self.field, jnp.take(self.limbs, pi.tbl, axis=0))

    def concat(self, other: "FArray") -> "FArray":
        return FArray(
            self.field, jnp.concatenate([self.limbs, other.limbs], axis=0)
        )

    def equals(self, other: "FArray") -> bool:
        return bool(
            jnp.array_equal(self.limbs, other.limbs)
        )

    def to_bytetree(self) -> ByteTree:
        bt = getattr(self, "_bt", None)
        if bt is None:
            bt = self.field.to_bytetree(self)
            self._bt = bt
        return bt

    def __repr__(self):
        return f"FArray(shape={self.shape}, {self.field})"


# =====================================================================
# Multiplicative group  (safe-prime subgroup)
# =====================================================================


class ModPGroup:
    """Subgroup of prime order q of Z_p^* (reference: arithm.ModPGroup).

    For a safe prime p = 2q+1 the subgroup is the quadratic residues and
    the co-order is 2.  Elements live on device in Montgomery form.
    """

    MARSHAL_NAME = "com.verificatum.arithm.ModPGroup"

    def __init__(self, p: int, q: int, g: int, encoding: int = 1):
        if (p - 1) % q != 0:
            raise ValueError("q must divide p-1")
        self.p = p
        self.q = q
        self.g_int = g
        self.encoding = encoding
        self.coorder = (p - 1) // q
        self.ctx = MontCtx(p)
        self.L = self.ctx.L
        self.nbits = p.bit_length()
        self.bytelen = _bytelen(p)
        self.ring = PField(q)
        self._g = None
        self._p_bytes = p.to_bytes((p.bit_length() + 7) // 8, "big")

    # ----------------------------------------------------------- named

    _NAMED = {}

    @classmethod
    def named(cls, name: str) -> "ModPGroup":
        grp = cls._NAMED.get(name)
        if grp is None:
            p, g = _NAMED_GROUPS[name]
            grp = cls(p, (p - 1) // 2, g)
            cls._NAMED[name] = grp
        return grp

    # ------------------------------------------------------------ build

    @property
    def g(self) -> "GArray":
        """Standard generator."""
        if self._g is None:
            self._g = self.from_ints([self.g_int]).get(0)
        return self._g

    def one(self, shape=()) -> "GArray":
        om = jnp.asarray(self.ctx.one_mont)
        return GArray(self, jnp.broadcast_to(om, tuple(shape) + (self.L,)))

    def from_ints(self, xs: Sequence[int]) -> "GArray":
        return GArray(self, self.ctx.encode([x % self.p for x in xs]))

    def random_array(self, n: int, prg, rbitlen: int) -> "GArray":
        """Derive n group elements from a PRG byte stream
        (reference: ModPGroup.randomElementArray — each element is an
        (nbits+rbitlen)-bit integer reduced mod p raised to the co-order;
        used for independent generators, IndependentGeneratorsRO.java:129).
        """
        bits = self.nbits + rbitlen
        nbytes = (bits + 7) // 8
        raw = np.frombuffer(prg.read_bytes(n * nbytes), np.uint8).reshape(
            n, nbytes
        )
        extra = 8 * nbytes - bits
        if extra:
            raw = raw.copy()
            raw[:, 0] &= 0xFF >> extra
        # Vectorized: limbs -> batched reduction mod p -> Montgomery form.
        Lw = max(self.L, num_limbs(bits))
        wide = device_limbs(bytes_be_to_limbs(raw, Lw))
        base = self.ctx.to_mont(self.ctx.reduce_std(wide))
        # raise to co-order to land in the subgroup
        e = jnp.asarray(int_to_limbs(self.coorder, num_limbs(64)))
        return GArray(
            self,
            self.ctx.exp(base, e, self.coorder.bit_length()),
        )

    # --------------------------------------------------------- serialize

    def elem_to_bytetree(self, ga: "GArray") -> ByteTree:
        from vmn_tpu.eio.bytetree import array_leaf_node

        arr = host_limbs(self.ctx.from_mont(ga.limbs))
        if arr.ndim == 1:
            return leaf(limbs_to_bytes_be(arr[None], self.bytelen)[0].tobytes())
        b = limbs_to_bytes_be(arr.reshape(-1, self.L), self.bytelen)
        return array_leaf_node(b)

    def elem_from_bytetree(
        self, bt: ByteTree, size: Optional[int] = None, validate: bool = True
    ) -> "GArray":
        """Parse element/array; validates subgroup membership x^q == 1
        (reference: ModPGroup.toElementArray verifies membership)."""
        from vmn_tpu.eio.bytetree import parse_uniform_array

        scalar = bt.is_leaf
        if scalar:
            if len(bt.data) != self.bytelen:
                raise ByteTreeError("wrong element byte length")
            raw = np.frombuffer(bt.data, np.uint8)[None]
        else:
            raw = parse_uniform_array(bt)
            if raw is None or raw.shape[1] != self.bytelen:
                raise ByteTreeError("malformed element array")
            if size is not None and raw.shape[0] != size:
                raise ByteTreeError(
                    f"wrong array length {raw.shape[0]} != {size}"
                )
        limbs = bytes_be_to_limbs(raw, self.L)
        # vectorized range check: 0 < x < p
        if not _range_check_be(raw, self.p, self.bytelen):
            raise ByteTreeError("element out of range")
        validated = False
        defer_qr_device = False
        hook = getattr(_DEFER_TLS, "hook", None)
        if validate and self.coorder == 2:
            # Safe-prime groups: membership x in QR(p) <=> (x|p) == 1.
            # The native batch Jacobi runs on the host bytes during the
            # parse — the reference's GMP mpz_jacobi equivalent
            # (SURVEY.md §2.3) — replacing a full batched device
            # exponentiation x^q per parsed array (the standalone
            # verifier's dominant cost).
            from vmn_tpu.native.build import get_lib, jacobi_batch

            import os as _os

            if hook is not None and raw.shape[0] >= self._QR_DEVICE_N:
                # Large arrays: batched randomized QR test on the device
                # (see _qr_check_device); host Jacobi at 2^20 elements
                # costs minutes.  Below the floor the native Jacobi runs
                # on a worker thread, hidden under the device equation
                # work (the device pass ADDS ~100 N-wide products per
                # array to the device critical path).
                defer_qr_device = True
                validated = True
            elif (hook is not None and raw.shape[0] >= 256
                    and get_lib() is not None):
                pb = self._p_bytes

                jac_threads = max(1, min(16, (_os.cpu_count() or 2) - 2))

                def _check(raw=raw, pb=pb, nt=jac_threads):
                    # Leave >=2 cores free: the deferred checks run
                    # CONCURRENTLY with device work, whose dispatch
                    # loop needs host cores.
                    ok = jacobi_batch(raw, pb, nthreads=nt)
                    return ok is not None and bool(ok.all())

                hook(_check)
                validated = True
            else:
                ok = jacobi_batch(raw, self._p_bytes)
                if ok is not None:
                    if not bool(ok.all()):
                        raise ByteTreeError("element not in subgroup")
                    validated = True
        ga = GArray(self, self.ctx.to_mont(device_limbs(limbs)))
        if defer_qr_device:
            hook(self._qr_check_device(ga.limbs))
        if validate and not validated and not ga.is_in_group():
            raise ByteTreeError("element not in subgroup")
        if scalar:
            g0 = ga.get(0)
            # Scalar memo: a later to_bytetree would otherwise fetch a
            # single element from the device MID-PIPELINE, stalling the
            # host behind all queued device work.
            g0._bt = bt
            return g0
        # Seed the serialization memo: the canonical fixed-size encoding
        # of a parsed array is the input itself, so a later export of
        # this array (transcript writes in the shuffle/decrypt chains)
        # costs no device fetch.
        ga._bt = bt
        return ga

    # 100 independent 4-bit digit positions -> soundness 2^-100, the
    # protocol's statistical-distance order (docs/DEVIATIONS.md #3)
    _QR_BITS = 400
    # arrays at least this long take the device QR test
    _QR_DEVICE_N = 1 << 18

    def _qr_check_device(self, mont_limbs):
        """Batched randomized quadratic-residuosity test on device.

        Draws verifier-local uniform 400-bit exponents r_i and computes
        the per-digit-position products P_j = prod_i x_i^{d_ij}
        (`MontCtx.expprod_positions`).  The Legendre character is multiplicative, so
        if ANY x_i is a non-residue each P_j is a non-residue with
        independent probability 1/2 — all 100 positions passing has
        probability 2^-100.  Montgomery form is transparent to the test:
        chi(R) = chi(2)^(16L) = +1 (even power).

        Device work is dispatched immediately (async); the returned
        thunk fetches the ~100 scalars and Jacobi-checks them on the
        host (microseconds).
        """
        import os as _os

        n = mont_limbs.shape[0]
        lw = self._QR_BITS // LIMB_BITS
        key = jax.random.PRNGKey(
            int.from_bytes(_os.urandom(7), "big")
        )
        e = jax.random.bits(key, (n, lw), jnp.uint32) & jnp.uint32(0xFFFF)
        P = self.ctx.expprod_positions(mont_limbs, e, self._QR_BITS)

        def _check(P=P):
            from vmn_tpu.native.build import jacobi_batch

            arr = host_limbs(P)  # tiny fetch; waits for device
            raw = limbs_to_bytes_be(arr, self.bytelen)
            ok = jacobi_batch(raw, self._p_bytes, nthreads=1)
            if ok is not None:
                return bool(ok.all())
            e2 = (self.p - 1) // 2
            return all(
                pow(v, e2, self.p) == 1
                for v in limbs_to_ints(arr)
            )

        return _check

    def to_bytetree(self) -> ByteTree:
        from vmn_tpu.eio.bytetree import signed_int_leaf

        return node(
            signed_int_leaf(self.p),
            signed_int_leaf(self.q),
            self.elem_to_bytetree(self.g),
            int_leaf(self.encoding),
        )

    @classmethod
    def from_bytetree(cls, bt: ByteTree) -> "ModPGroup":
        p = bt[0].to_int_signed()
        q = bt[1].to_int_signed()
        enc = bt[3].to_u32()
        grp = cls(p, q, 1, enc)
        grp.g_int = grp.elem_from_bytetree(bt[2]).to_ints()[0]
        grp._g = None
        return grp

    # ----------------------------------------------------- plain encode

    def encode_message(self, msg: bytes) -> int:
        """Encode a message into a group element (safe-prime encoding:
        value m+1 or p-(m+1), whichever is a QR — reference ModPGroup
        RO_ENCODING/SAFEPRIME_ENCODING).  Messages are limited to
        nbits//8 - 4 bytes."""
        return self.encode_messages([msg])[0]

    def _encode_candidate(self, msg: bytes) -> int:
        mlen = self.nbits // 8 - 4
        if len(msg) > mlen:
            raise ValueError("message too long")
        padded = len(msg).to_bytes(4, "big") + msg.ljust(mlen, b"\x00")
        return int.from_bytes(padded, "big") + 1

    def encode_messages(self, msgs) -> list:
        """`encode_message` over a batch.  For safe-prime groups the QR
        test of all candidates is one native batch Jacobi call (Euler's
        criterion: m^q = 1 iff (m|p) = 1) instead of a host pow each."""
        cands = [self._encode_candidate(msg) for msg in msgs]
        ok = None
        if self.coorder == 2 and cands:
            from vmn_tpu.native.build import jacobi_batch

            raw = np.frombuffer(
                b"".join(c.to_bytes(self.bytelen, "big") for c in cands),
                np.uint8,
            ).reshape(len(cands), self.bytelen)
            ok = jacobi_batch(raw, self._p_bytes)
        if ok is None:
            ok = [pow(c, self.q, self.p) == 1 for c in cands]
        return [c if o else self.p - c for c, o in zip(cands, ok)]

    def decode_message(self, x: int) -> bytes:
        mlen = self.nbits // 8 - 4
        for cand in (x, self.p - x):
            m = cand - 1
            if not 0 <= m < 1 << (8 * (mlen + 4)):
                continue
            raw = m.to_bytes(mlen + 4, "big")
            n = int.from_bytes(raw[:4], "big")
            if n <= mlen:
                return raw[4 : 4 + n]
        # mirror reference behavior: undecodable -> empty
        return b""

    def __eq__(self, other):
        return (
            isinstance(other, ModPGroup)
            and other.p == self.p
            and other.q == self.q
            and other.g_int == self.g_int
        )

    def __repr__(self):
        return f"ModPGroup({self.nbits} bits)"


class GArray:
    """Array (or scalar) of group elements in Montgomery form."""

    __slots__ = ("grp", "limbs", "_bt")

    def spill(self) -> "GArray":
        """Disk-spill backend hook (arrays=file)."""
        from vmn_tpu.arith import storage

        return GArray(self.grp, storage.maybe_spill(self.limbs))

    def __init__(self, grp: ModPGroup, limbs):
        self.grp = grp
        self.limbs = limbs

    # -------------------------------------------------------------- meta

    @property
    def shape(self):
        return self.limbs.shape[:-1]

    @property
    def size(self) -> int:
        return int(self.limbs.shape[0])

    def __len__(self):
        return self.size

    def get(self, i: int) -> "GArray":
        return GArray(self.grp, self.limbs[i])

    def copy_of_range(self, a: int, b: int) -> "GArray":
        return GArray(self.grp, self.limbs[a:b])

    def broadcast(self, n: int) -> "GArray":
        assert self.limbs.ndim == 1
        return GArray(
            self.grp,
            jnp.broadcast_to(self.limbs, (n,) + self.limbs.shape),
        )

    def to_ints(self) -> List[int]:
        arr = host_limbs(self.grp.ctx.from_mont(self.limbs))
        if arr.ndim == 1:
            return [limbs_to_int(arr)]
        return limbs_to_ints(arr)

    # --------------------------------------------------------------- ops

    def mul(self, other: "GArray") -> "GArray":
        return GArray(self.grp, self.grp.ctx.mul(self.limbs, other.limbs))

    def div(self, other: "GArray") -> "GArray":
        return self.mul(other.inv())

    def inv(self) -> "GArray":
        return GArray(self.grp, self.grp.ctx.inv(self.limbs))

    def exp(self, e: Union[FArray, int]) -> "GArray":
        """Element-wise power; broadcasts scalar^array and array^scalar."""
        if isinstance(e, int):
            e = self.grp.ring.from_int(e)
        return GArray(
            self.grp,
            self.grp.ctx.exp(self.limbs, e.limbs, self.grp.ring.nbits),
        )

    def exp_bits(self, e: FArray, nbits: int) -> "GArray":
        """Power with a declared exponent bit bound (raised-exponent
        optimisation, reference: CCPoS raised values)."""
        return GArray(self.grp, self.grp.ctx.exp(self.limbs, e.limbs, nbits))

    def exp_prod(self, e: FArray, nbits: Optional[int] = None) -> "GArray":
        """prod_i self_i^{e_i} — simultaneous multi-exponentiation
        (reference: PGroupElementArray.expProd via gmpmee spowm)."""
        nbits = self.grp.ring.nbits if nbits is None else nbits
        return GArray(
            self.grp,
            self.grp.ctx.expprod(self.limbs, e.limbs, nbits),
        )

    def exp_mul(self, v: FArray, other: "GArray") -> "GArray":
        """self^v * other (reference: PGroupElement.expMul)."""
        return self.exp(v).mul(other)

    def prod(self) -> "GArray":
        return GArray(self.grp, self.grp.ctx.prod(self.limbs, axis=0))

    def permute(self, pi: Permutation) -> "GArray":
        return GArray(self.grp, jnp.take(self.limbs, pi.tbl, axis=0))

    def shift_push(self, first: "GArray") -> "GArray":
        f = jnp.broadcast_to(first.limbs, (1, self.grp.L))
        return GArray(
            self.grp, jnp.concatenate([f, self.limbs[:-1]], axis=0)
        )

    def concat(self, other: "GArray") -> "GArray":
        return GArray(
            self.grp, jnp.concatenate([self.limbs, other.limbs], axis=0)
        )

    def take(self, idx: np.ndarray) -> "GArray":
        return GArray(self.grp, jnp.take(self.limbs, idx, axis=0))

    def equals(self, other: "GArray") -> bool:
        return bool(jnp.array_equal(self.limbs, other.limbs))

    def is_in_group(self) -> bool:
        """Batch subgroup-membership check: x^q == 1 for all elements."""
        qL = num_limbs(self.grp.q.bit_length())
        eq = jnp.asarray(int_to_limbs(self.grp.q, qL))
        powed = self.grp.ctx.exp(
            self.limbs, eq, self.grp.q.bit_length()
        )
        one = jnp.broadcast_to(
            jnp.asarray(self.grp.ctx.one_mont), powed.shape
        )
        return bool(jnp.array_equal(powed, one))

    def to_bytetree(self) -> ByteTree:
        """Serialized form, memoized: publish + transcript export + seed
        derivation reuse one device->host fetch (arrays are immutable)."""
        bt = getattr(self, "_bt", None)
        if bt is None:
            bt = self.grp.elem_to_bytetree(self)
            self._bt = bt
        return bt

    def __repr__(self):
        return f"GArray(shape={self.shape}, {self.grp})"


# =====================================================================
# Product groups (pytrees of GArray)
# =====================================================================


class PPGroup:
    """Product group: tuple of component groups (reference: PPGroup).

    Used for key widening (keywidth), plaintext width (width) and the
    2-component El Gamal ciphertext structure
    (reference: ProtocolElGamal.java:738-776).
    """

    MARSHAL_NAME = "com.verificatum.arithm.PPGroup"

    def __init__(self, *factors):
        if len(factors) == 2 and isinstance(factors[1], int):
            factors = (factors[0],) * factors[1]
        self.factors: tuple = tuple(factors)

    @property
    def width(self) -> int:
        return len(self.factors)

    def project(self, i: int):
        return self.factors[i]

    @property
    def ring(self) -> "PPRing":
        return PPRing(*[f.ring for f in self.factors])

    @property
    def g(self) -> "PPArray":
        """Standard generator: product of component generators."""
        return PPArray(self, tuple(f.g for f in self.factors))

    def one(self, shape=()) -> "PPArray":
        return PPArray(self, tuple(f.one(shape) for f in self.factors))

    def product(self, *elements) -> "PPArray":
        assert len(elements) == len(self.factors)
        return PPArray(self, tuple(elements))

    def random_array(self, n: int, prg, rbitlen: int) -> "PPArray":
        return PPArray(
            self,
            tuple(f.random_array(n, prg, rbitlen) for f in self.factors),
        )

    def elem_from_bytetree(self, bt, size=None, validate=True):
        if bt.is_leaf or len(bt.children) != self.width:
            raise ByteTreeError("malformed product-group element")
        return PPArray(
            self,
            tuple(
                f.elem_from_bytetree(c, size, validate)
                for f, c in zip(self.factors, bt.children)
            ),
        )

    def to_bytetree(self) -> ByteTree:
        return node(*[f.to_bytetree() for f in self.factors])

    def equals(self, other) -> bool:
        return (
            isinstance(other, PPGroup)
            and len(other.factors) == len(self.factors)
            and all(a == b for a, b in zip(self.factors, other.factors))
        )

    __eq__ = equals

    def __repr__(self):
        return f"PPGroup({self.factors!r})"


class PPRing:
    """Product ring: tuple of component rings/fields."""

    def __init__(self, *factors):
        if len(factors) == 2 and isinstance(factors[1], int):
            factors = (factors[0],) * factors[1]
        self.factors: tuple = tuple(factors)

    @property
    def width(self) -> int:
        return len(self.factors)

    def project(self, i: int):
        return self.factors[i]

    def random(self, shape, randomsource, rbitlen: int) -> "PPFArray":
        return PPFArray(
            self,
            tuple(f.random(shape, randomsource, rbitlen) for f in self.factors),
        )

    def from_ints(self, xs) -> "PPFArray":
        """Same integer values in every component (diagonal embedding)."""
        return PPFArray(self, tuple(f.from_ints(xs) for f in self.factors))

    def from_int(self, x: int) -> "PPFArray":
        return PPFArray(self, tuple(f.from_int(x) for f in self.factors))

    def zeros(self, shape=()) -> "PPFArray":
        return PPFArray(self, tuple(f.zeros(shape) for f in self.factors))

    def product(self, *elements) -> "PPFArray":
        return PPFArray(self, tuple(elements))

    def from_bytetree(self, bt, size=None):
        if bt.is_leaf or len(bt.children) != self.width:
            raise ByteTreeError("malformed product-ring element")
        return PPFArray(
            self,
            tuple(
                f.from_bytetree(c, size)
                for f, c in zip(self.factors, bt.children)
            ),
        )

    def __eq__(self, other):
        return (
            isinstance(other, PPRing)
            and len(other.factors) == len(self.factors)
            and all(a == b for a, b in zip(self.factors, other.factors))
        )

    def __repr__(self):
        return f"PPRing({self.factors!r})"


def _zip_op(name):
    def op(self, other):
        assert len(self.components) == len(other.components)
        return type(self)(
            self.parent,
            tuple(
                getattr(a, name)(b)
                for a, b in zip(self.components, other.components)
            ),
        )

    return op


def _map_op(name):
    def op(self, *args):
        return type(self)(
            self.parent,
            tuple(getattr(a, name)(*args) for a in self.components),
        )

    return op


class PPArray:
    """Element (array) of a product group: tuple of component arrays."""

    __slots__ = ("parent", "components")

    def spill(self) -> "PPArray":
        """Disk-spill backend hook (arrays=file)."""
        return PPArray(self.parent,
                       tuple(c.spill() for c in self.components))

    def __init__(self, parent: PPGroup, components: tuple):
        self.parent = parent
        self.components = tuple(components)

    @property
    def grp(self) -> PPGroup:
        return self.parent

    @property
    def size(self) -> int:
        return self.components[0].size

    def project(self, i: int):
        return self.components[i]

    mul = _zip_op("mul")
    div = _zip_op("div")

    inv = _map_op("inv")
    prod = _map_op("prod")
    permute = _map_op("permute")
    get = _map_op("get")
    copy_of_range = _map_op("copy_of_range")
    broadcast = _map_op("broadcast")
    take = _map_op("take")

    def _ring_matches(self, e) -> bool:
        """True when `e` is an element of THIS product group's ring, so
        the exponent maps componentwise (reference: PPGroupElement.exp
        — any other ring element is applied to every component).  The
        check is structural ring equality, NOT component count: for a
        width-2 ciphertext both the (u,v) pair and the width axis have
        two components, and a width-2 plain-ring exponent must recurse
        into each of u and v, not zip across them."""
        return isinstance(e, PPFArray) and self.parent.ring == e.parent

    def exp(self, e) -> "PPArray":
        """Exponent semantics (reference: PPGroupElement.exp): a matching
        product-ring exponent maps componentwise; any other exponent is
        applied to every component."""
        if self._ring_matches(e):
            return PPArray(
                self.parent,
                tuple(
                    a.exp(b) for a, b in zip(self.components, e.components)
                ),
            )
        return PPArray(self.parent, tuple(a.exp(e) for a in self.components))

    def exp_bits(self, e, nbits: int) -> "PPArray":
        if self._ring_matches(e):
            return PPArray(
                self.parent,
                tuple(
                    a.exp_bits(b, nbits)
                    for a, b in zip(self.components, e.components)
                ),
            )
        return PPArray(
            self.parent, tuple(a.exp_bits(e, nbits) for a in self.components)
        )

    def exp_prod(self, e, nbits=None) -> "PPArray":
        if self._ring_matches(e):
            return PPArray(
                self.parent,
                tuple(
                    a.exp_prod(b, nbits)
                    for a, b in zip(self.components, e.components)
                ),
            )
        return PPArray(
            self.parent, tuple(a.exp_prod(e, nbits) for a in self.components)
        )

    def exp_mul(self, v, other: "PPArray") -> "PPArray":
        return self.exp(v).mul(other)

    def shift_push(self, first: "PPArray") -> "PPArray":
        return PPArray(
            self.parent,
            tuple(
                a.shift_push(b)
                for a, b in zip(self.components, first.components)
            ),
        )

    def concat(self, other: "PPArray") -> "PPArray":
        return PPArray(
            self.parent,
            tuple(
                a.concat(b) for a, b in zip(self.components, other.components)
            ),
        )

    def equals(self, other) -> bool:
        return all(
            a.equals(b) for a, b in zip(self.components, other.components)
        )

    def is_in_group(self) -> bool:
        return all(a.is_in_group() for a in self.components)

    def to_bytetree(self) -> ByteTree:
        return node(*[a.to_bytetree() for a in self.components])

    def __repr__(self):
        return f"PPArray({self.components!r})"


class PPFArray:
    """Element (array) of a product ring: tuple of component FArrays."""

    __slots__ = ("parent", "components")

    def spill(self):
        """Disk-spill backend hook (arrays=file)."""
        return type(self)(self.parent,
                          tuple(c.spill() for c in self.components))

    def __init__(self, parent: PPRing, components: tuple):
        self.parent = parent
        self.components = tuple(components)

    @property
    def ring(self) -> PPRing:
        return self.parent

    @property
    def size(self) -> int:
        return self.components[0].size

    def project(self, i: int):
        return self.components[i]

    def _zip_or_map(self, other, name):
        """Zip with a matching product-ring element, otherwise apply the
        scalar/base-ring operand to every component (reference:
        PPRingElement arithmetic semantics)."""
        if isinstance(other, PPFArray) and other.parent == self.parent:
            return PPFArray(
                self.parent,
                tuple(
                    getattr(a, name)(b)
                    for a, b in zip(self.components, other.components)
                ),
            )
        return PPFArray(
            self.parent,
            tuple(getattr(a, name)(other) for a in self.components),
        )

    def add(self, other) -> "PPFArray":
        return self._zip_or_map(other, "add")

    def sub(self, other) -> "PPFArray":
        return self._zip_or_map(other, "sub")

    def mul(self, other) -> "PPFArray":
        return self._zip_or_map(other, "mul")

    neg = _map_op("neg")
    sum = _map_op("sum")
    permute = _map_op("permute")
    get = _map_op("get")
    copy_of_range = _map_op("copy_of_range")

    def mul_add(self, v, t: "PPFArray") -> "PPFArray":
        if isinstance(v, PPFArray):
            return PPFArray(
                self.parent,
                tuple(
                    a.mul_add(vv, tt)
                    for a, vv, tt in zip(
                        self.components, v.components, t.components
                    )
                ),
            )
        return PPFArray(
            self.parent,
            tuple(
                a.mul_add(v, tt)
                for a, tt in zip(self.components, t.components)
            ),
        )

    def inner_product(self, other) -> "PPFArray":
        if isinstance(other, PPFArray):
            return PPFArray(
                self.parent,
                tuple(
                    a.inner_product(b)
                    for a, b in zip(self.components, other.components)
                ),
            )
        return PPFArray(
            self.parent, tuple(a.inner_product(other) for a in self.components)
        )

    def concat(self, other: "PPFArray") -> "PPFArray":
        return PPFArray(
            self.parent,
            tuple(
                a.concat(b) for a, b in zip(self.components, other.components)
            ),
        )

    def equals(self, other) -> bool:
        return all(
            a.equals(b) for a, b in zip(self.components, other.components)
        )

    def to_bytetree(self) -> ByteTree:
        return node(*[a.to_bytetree() for a in self.components])

    def __repr__(self):
        return f"PPFArray({self.components!r})"


# =====================================================================
# Named groups
# =====================================================================

# RFC 3526 MODP primes (safe primes); generator 4 = 2^2 generates the
# prime-order subgroup of quadratic residues.
_RFC3526_2048 = int(
    "FFFFFFFFFFFFFFFFC90FDAA22168C234C4C6628B80DC1CD129024E088A67CC74"
    "020BBEA63B139B22514A08798E3404DDEF9519B3CD3A431B302B0A6DF25F1437"
    "4FE1356D6D51C245E485B576625E7EC6F44C42E9A637ED6B0BFF5CB6F406B7ED"
    "EE386BFB5A899FA5AE9F24117C4B1FE649286651ECE45B3DC2007CB8A163BF05"
    "98DA48361C55D39A69163FA8FD24CF5F83655D23DCA3AD961C62F356208552BB"
    "9ED529077096966D670C354E4ABC9804F1746C08CA18217C32905E462E36CE3B"
    "E39E772C180E86039B2783A2EC07A28FB5C55DF06F4C52C9DE2BCBF695581718"
    "3995497CEA956AE515D2261898FA051015728E5A8AACAA68FFFFFFFFFFFFFFFF",
    16,
)
_RFC3526_3072 = int(
    "FFFFFFFFFFFFFFFFC90FDAA22168C234C4C6628B80DC1CD129024E088A67CC74"
    "020BBEA63B139B22514A08798E3404DDEF9519B3CD3A431B302B0A6DF25F1437"
    "4FE1356D6D51C245E485B576625E7EC6F44C42E9A637ED6B0BFF5CB6F406B7ED"
    "EE386BFB5A899FA5AE9F24117C4B1FE649286651ECE45B3DC2007CB8A163BF05"
    "98DA48361C55D39A69163FA8FD24CF5F83655D23DCA3AD961C62F356208552BB"
    "9ED529077096966D670C354E4ABC9804F1746C08CA18217C32905E462E36CE3B"
    "E39E772C180E86039B2783A2EC07A28FB5C55DF06F4C52C9DE2BCBF695581718"
    "3995497CEA956AE515D2261898FA051015728E5A8AAAC42DAD33170D04507A33"
    "A85521ABDF1CBA64ECFB850458DBEF0A8AEA71575D060C7DB3970F85A6E1E4C7"
    "ABF5AE8CDB0933D71E8C94E04A25619DCEE3D2261AD2EE6BF12FFA06D98A0864"
    "D87602733EC86A64521F2B18177B200CBBE117577A615D6C770988C0BAD946E2"
    "08E24FA074E5AB3143DB5BFCE0FD108E4B82D120A93AD2CAFFFFFFFFFFFFFFFF",
    16,
)
_RFC3526_4096 = int(
    "FFFFFFFFFFFFFFFFC90FDAA22168C234C4C6628B80DC1CD129024E088A67CC74"
    "020BBEA63B139B22514A08798E3404DDEF9519B3CD3A431B302B0A6DF25F1437"
    "4FE1356D6D51C245E485B576625E7EC6F44C42E9A637ED6B0BFF5CB6F406B7ED"
    "EE386BFB5A899FA5AE9F24117C4B1FE649286651ECE45B3DC2007CB8A163BF05"
    "98DA48361C55D39A69163FA8FD24CF5F83655D23DCA3AD961C62F356208552BB"
    "9ED529077096966D670C354E4ABC9804F1746C08CA18217C32905E462E36CE3B"
    "E39E772C180E86039B2783A2EC07A28FB5C55DF06F4C52C9DE2BCBF695581718"
    "3995497CEA956AE515D2261898FA051015728E5A8AAAC42DAD33170D04507A33"
    "A85521ABDF1CBA64ECFB850458DBEF0A8AEA71575D060C7DB3970F85A6E1E4C7"
    "ABF5AE8CDB0933D71E8C94E04A25619DCEE3D2261AD2EE6BF12FFA06D98A0864"
    "D87602733EC86A64521F2B18177B200CBBE117577A615D6C770988C0BAD946E2"
    "08E24FA074E5AB3143DB5BFCE0FD108E4B82D120A92108011A723C12A787E6D7"
    "88719A10BDBA5B2699C327186AF4E23C1A946834B6150BDA2583E9CA2AD44CE8"
    "DBBBC2DB04DE8EF92E8EFC141FBECAA6287C59474E6BC05D99B2964FA090C3A2"
    "233BA186515BE7ED1F612970CEE2D7AFB81BDD762170481CD0069127D5B05AA9"
    "93B4EA988D8FDDC186FFB7DC90A6C08F4DF435C934063199FFFFFFFFFFFFFFFF",
    16,
)

# 256-bit safe prime for fast tests (largest below 2^256).
_TEST256_P = int(
    "ffffffffffffffffffffffffffffffffffffffffffffffffffffffffffff72ef",
    16,
)

_NAMED_GROUPS = {
    "test256": (_TEST256_P, 4),
    "modp2048": (_RFC3526_2048, 4),
    "modp3072": (_RFC3526_3072, 4),
    "modp4096": (_RFC3526_4096, 4),
}

# Register groups for unmarshalling from config strings
# (reference: Marshalizer registry, ProtocolElGamal.java:352-434).
from vmn_tpu.eio.marshal import register as _register  # noqa: E402

_register(ModPGroup.MARSHAL_NAME)(ModPGroup)
