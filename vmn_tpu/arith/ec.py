"""Elliptic-curve groups over prime fields, batched on device.

Rebuild of the reference's EC stack (reference: VCR ECqPGroup backed by
the native `vec` C library, SURVEY.md §2.3) as batched limb-tensor
arithmetic: points are pairs of ``(..., L)`` coordinate tensors over
``MontCtx(p)``; point add/double are branchless Jacobian formulas
(a = -3 short Weierstrass, all NIST curves) evaluated across the batch
with `where`-selects for the identity/equal/inverse cases; scalar
multiplication is a fixed-window ladder like `mont_exp` but over point
operations.

Representation: affine-at-rest with an explicit infinity mask
(`x`, `y`, `inf` tensors); operations run in Jacobian internally and
normalize once per public op with a batched Montgomery-trick inversion
(two log-depth scans + one field exponentiation).

`ECqPGroup` / `ECArray` mirror the `ModPGroup` / `GArray` surface so
the whole protocol layer (El Gamal, TW proofs, mix-net sessions,
verifier) runs unchanged over EC groups.

Element byte-tree format: node(leaf(x), leaf(y)) with fixed-size
unsigned big-endian coordinates of ``p.bit_length()//8 + 1`` bytes; the
point at infinity uses all-0xFF coordinates (reference: VCR encodes
infinity as (-1, -1)).
"""

from __future__ import annotations

import functools
from typing import List, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from vmn_tpu.arith import mont
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
from vmn_tpu.arith.mont import MontCtx
from vmn_tpu.arith.pgroup import PField, _bytelen
from vmn_tpu.eio.bytetree import ByteTree, ByteTreeError, leaf, node


# ====================================================================
# Batched Jacobian point arithmetic over a Montgomery field context
# ====================================================================


def _select(mask, a, b):
    """mask (...,) bool -> elementwise choose a else b over limb axes."""
    return jnp.where(mask[..., None], a, b)


class _Curve:
    """Device constants for one curve; coordinates in Montgomery form."""

    def __init__(self, p: int, a: int, b: int):
        self.ctx = MontCtx(p)
        c = self.ctx
        self.a_m = jnp.asarray(int_to_limbs(a % p * c.R % p, c.L))
        self.b_m = jnp.asarray(int_to_limbs(b % p * c.R % p, c.L))
        self.zero = jnp.asarray(int_to_limbs(0, c.L))
        self.one_m = jnp.asarray(c.one_mont)

    # shorthand field ops (Montgomery form).  `mul` dispatches through
    # MontCtx so batched field products use the Montgomery core on the
    # GPU (and the shard_map wrappers for sharded batches).
    def mul(self, x, y):
        return self.ctx.mul(x, y)

    def add(self, x, y):
        return mont.add_mod(x, y, self.ctx.m_limbs)

    def sub(self, x, y):
        return mont.sub_mod(x, y, self.ctx.m_limbs)

    def sq(self, x):
        return self.mul(x, x)

    def dbl(self, x):
        return self.add(x, x)

    def is_zero(self, x):
        return jnp.all(x == 0, axis=-1)

    # ------------------------------------------------------- jacobian ops

    def point_double(self, X, Y, Z):
        """a = -3 Jacobian doubling (handles inf via Z=0; 2P with Y=0
        gives Z3=0 = inf, correct for order-2 points which NIST curves
        lack)."""
        delta = self.sq(Z)
        gamma = self.sq(Y)
        beta = self.mul(X, gamma)
        alpha = self.mul(
            self.add(self.dbl(self.sub(X, delta)), self.sub(X, delta)),
            self.add(X, delta),
        )  # 3(X-delta)(X+delta)
        beta4 = self.dbl(self.dbl(beta))
        beta8 = self.dbl(beta4)
        X3 = self.sub(self.sq(alpha), beta8)
        Z3 = self.sub(self.sub(self.sq(self.add(Y, Z)), gamma), delta)
        g2 = self.sq(gamma)
        g8 = self.dbl(self.dbl(self.dbl(g2)))
        Y3 = self.sub(self.mul(alpha, self.sub(beta4, X3)), g8)
        return X3, Y3, Z3

    def point_add(self, X1, Y1, Z1, X2, Y2, Z2):
        """Branchless general Jacobian addition."""
        Z1Z1 = self.sq(Z1)
        Z2Z2 = self.sq(Z2)
        U1 = self.mul(X1, Z2Z2)
        U2 = self.mul(X2, Z1Z1)
        S1 = self.mul(self.mul(Y1, Z2), Z2Z2)
        S2 = self.mul(self.mul(Y2, Z1), Z1Z1)
        H = self.sub(U2, U1)
        R = self.sub(S2, S1)

        HH = self.sq(H)
        HHH = self.mul(H, HH)
        V = self.mul(U1, HH)
        X3 = self.sub(self.sub(self.sq(R), HHH), self.dbl(V))
        Y3 = self.sub(self.mul(R, self.sub(V, X3)), self.mul(S1, HHH))
        Z3 = self.mul(self.mul(Z1, Z2), H)

        # Exceptional cases.
        p1_inf = self.is_zero(Z1)
        p2_inf = self.is_zero(Z2)
        h_zero = self.is_zero(H)
        r_zero = self.is_zero(R)
        same = jnp.logical_and(h_zero, r_zero)  # P == Q  -> double
        opp = jnp.logical_and(h_zero, jnp.logical_not(r_zero))  # P == -Q

        dX, dY, dZ = self.point_double(X1, Y1, Z1)

        X3 = _select(same, dX, X3)
        Y3 = _select(same, dY, Y3)
        Z3 = _select(same, dZ, Z3)
        # P + (-P) = inf
        Z3 = _select(
            jnp.logical_and(
                opp, jnp.logical_not(jnp.logical_or(p1_inf, p2_inf))
            ),
            jnp.zeros_like(Z3), Z3,
        )
        # identity cases
        X3 = _select(p1_inf, X2, X3)
        Y3 = _select(p1_inf, Y2, Y3)
        Z3 = _select(p1_inf, Z2, Z3)
        X3 = _select(p2_inf, X1, X3)
        Y3 = _select(p2_inf, Y1, Y3)
        Z3 = _select(p2_inf, Z1, Z3)
        return X3, Y3, Z3

    def normalize(self, X, Y, Z):
        """Jacobian -> affine + inf mask, via batched inversion."""
        inf = self.is_zero(Z)
        # Avoid inverting zeros: substitute 1.
        Zs = _select(inf, jnp.broadcast_to(self.one_m, Z.shape), Z)
        Zi = self.batch_inv(Zs)
        Zi2 = self.sq(Zi)
        x = self.mul(X, Zi2)
        y = self.mul(Y, self.mul(Zi, Zi2))
        x = _select(inf, jnp.zeros_like(x), x)
        y = _select(inf, jnp.zeros_like(y), y)
        return x, y, inf

    def batch_inv(self, z):
        """Montgomery-trick batched inversion of (..., L) nonzero
        elements: one field exp + O(N log N) muls in 2 Hillis-Steele
        scans.  The scans dispatch through MontCtx.prods_scan, so every
        round is ONE batched product over the batch (an associative
        scan of XLA products dominated every EC point operation's cost
        via `normalize`)."""
        c = self.ctx
        if z.ndim == 1:
            return self.inv_single(z)
        pre = c.prods_scan(z)  # inclusive prefix products
        total_inv = self.inv_single(pre[-1])
        rev = jnp.flip(z, axis=0)
        suf = c.prods_scan(rev)
        # inv_prefix_i = total_inv * prod_{j>i} z_j
        ones = jnp.broadcast_to(self.one_m, (1,) + z.shape[1:])
        suffix_after = jnp.concatenate(
            [jnp.flip(suf[:-1], axis=0), ones], axis=0
        )  # prod_{j>i} z_j
        inv_prefix = self.mul(
            jnp.broadcast_to(total_inv, z.shape), suffix_after
        )
        prefix_before = jnp.concatenate(
            [jnp.broadcast_to(self.one_m, (1,) + z.shape[1:]), pre[:-1]],
            axis=0,
        )
        return self.mul(inv_prefix, prefix_before)

    def inv_single(self, z):
        """Fermat inversion of a single (or broadcast) element."""
        c = self.ctx
        e_int = c.m - 2
        e = jnp.asarray(int_to_limbs(e_int, c.L))
        return c.exp(z, e, c.nbits)


# ====================================================================
# Scalar multiplication
# ====================================================================

_WINDOW = 4


@functools.partial(jax.jit, static_argnames=("curve", "nbits"))
def _scalar_mul(curve: _Curve, x, y, inf, e, nbits: int):
    """Fixed-window scalar multiplication, batched.

    x, y: (..., L) affine Montgomery coords; inf: (...,) bool;
    e: (..., Le) standard-form scalar limbs.
    """
    shape = jnp.broadcast_shapes(x.shape[:-1], e.shape[:-1])
    L = x.shape[-1]
    x = jnp.broadcast_to(x, shape + (L,))
    y = jnp.broadcast_to(y, shape + (L,))
    inf = jnp.broadcast_to(inf, shape)
    e = jnp.broadcast_to(e, shape + e.shape[-1:])

    # Build table of multiples 0..15 in Jacobian form with a scan
    # (single traced body — keeps the compiled graph small).
    Z1 = jnp.broadcast_to(curve.one_m, shape + (L,))
    Z1 = _select(inf, jnp.zeros_like(Z1), Z1)  # inf -> Z=0

    def tbl_step(carry, _):
        nxt = curve.point_add(*carry, x, y, Z1)
        return nxt, nxt

    _, tail = jax.lax.scan(
        tbl_step, (x, y, Z1), None, length=(1 << _WINDOW) - 2
    )
    # tail: each leaf (14, ..., L); prepend entries 0 (inf) and 1 (P)
    def cat(zero_e, one_e, t):
        return jnp.concatenate(
            [zero_e[None], one_e[None], t], axis=0
        )

    tX = cat(jnp.zeros_like(x), x, tail[0])  # (16, ..., L)
    tY = cat(jnp.broadcast_to(curve.one_m, shape + (L,)), y, tail[1])
    tZ = cat(jnp.zeros_like(Z1), Z1, tail[2])

    ndig = (nbits + _WINDOW - 1) // _WINDOW
    digits_per_limb = 16 // _WINDOW

    accX = jnp.zeros(shape + (L,), jnp.uint32)
    accY = jnp.broadcast_to(curve.one_m, shape + (L,))
    accZ = jnp.zeros(shape + (L,), jnp.uint32)

    def body(k, acc):
        aX, aY, aZ = jax.lax.fori_loop(
            0, _WINDOW,
            lambda _, a: curve.point_double(*a),
            acc,
        )
        j = ndig - 1 - k
        limb = j // digits_per_limb
        shift = (j % digits_per_limb) * _WINDOW
        el = jax.lax.dynamic_slice_in_dim(e, limb, 1, axis=-1)[..., 0]
        dig = ((el >> shift) & 0xF).astype(jnp.int32)
        idx = jnp.broadcast_to(dig[None, ..., None], (1,) + shape + (L,))
        fX = jnp.take_along_axis(tX, idx, axis=0)[0]
        fY = jnp.take_along_axis(tY, idx, axis=0)[0]
        fZ = jnp.take_along_axis(tZ, idx, axis=0)[0]
        return curve.point_add(aX, aY, aZ, fX, fY, fZ)

    accX, accY, accZ = jax.lax.fori_loop(0, ndig, body, (accX, accY, accZ))
    return curve.normalize(accX, accY, accZ)


# ====================================================================
# Group + element array classes (GArray-compatible surface)
# ====================================================================


class ECqPGroup:
    """Prime-order EC group (reference: VCR arithm.ECqPGroup)."""

    MARSHAL_NAME = "com.verificatum.arithm.ECqPGroup"

    def __init__(self, name: str, p: int, a: int, b: int, gx: int, gy: int,
                 n: int):
        self.name = name
        self.p = p
        self.a = a % p
        self.b = b % p
        self.gx = gx
        self.gy = gy
        self.n = n  # group order (prime)
        self.curve = _Curve(p, a, b)
        self.ctx = self.curve.ctx
        self.L = self.ctx.L
        self.nbits = n.bit_length()
        self.fbytelen = _bytelen(p)
        self.ring = PField(n)
        self._g = None

    _NAMED = {}

    @classmethod
    def named(cls, name: str) -> "ECqPGroup":
        grp = cls._NAMED.get(name)
        if grp is None:
            par = _CURVES[name]
            grp = cls(name, *par)
            cls._NAMED[name] = grp
        return grp

    # ------------------------------------------------------------- build

    @property
    def g(self) -> "ECArray":
        if self._g is None:
            self._g = self.from_affine([(self.gx, self.gy)]).get(0)
        return self._g

    def one(self, shape=()) -> "ECArray":
        z = jnp.zeros(tuple(shape) + (self.L,), jnp.uint32)
        return ECArray(self, z, z, jnp.ones(tuple(shape), bool))

    def from_affine(self, pts: Sequence[tuple]) -> "ECArray":
        xs = [p[0] for p in pts]
        ys = [p[1] for p in pts]
        return ECArray(
            self,
            self.ctx.encode(xs),
            self.ctx.encode(ys),
            jnp.zeros((len(pts),), bool),
        )

    def to_affine(self, arr: "ECArray") -> List[Optional[tuple]]:
        xs = arr.grp.ctx.decode(arr.x)
        ys = arr.grp.ctx.decode(arr.y)
        infs = np.asarray(arr.inf).reshape(-1)
        return [
            None if i else (x, y) for x, y, i in zip(xs, ys, infs)
        ]

    def sqrt(self, v: int) -> Optional[int]:
        """Modular square root (host-side; used for encoding and PRG
        point derivation)."""
        p = self.p
        if pow(v, (p - 1) // 2, p) != 1:
            return None if v % p != 0 else 0
        if p % 4 == 3:
            return pow(v, (p + 1) // 4, p)
        # Tonelli-Shanks for p = 1 mod 4 (P-224)
        q, s = p - 1, 0
        while q % 2 == 0:
            q //= 2
            s += 1
        z = 2
        while pow(z, (p - 1) // 2, p) != p - 1:
            z += 1
        m, c, t, r = s, pow(z, q, p), pow(v, q, p), pow(v, (q + 1) // 2, p)
        while t != 1:
            i, tt = 0, t
            while tt != 1:
                tt = tt * tt % p
                i += 1
            b = pow(c, 1 << (m - i - 1), p)
            m, c = i, b * b % p
            t = t * c % p
            r = r * b % p
        return r

    def curve_y(self, x: int) -> Optional[int]:
        """y with (x, y) on curve, or None."""
        rhs = (pow(x, 3, self.p) + self.a * x + self.b) % self.p
        return self.sqrt(rhs)

    def random_array(self, nelem: int, prg, rbitlen: int) -> "ECArray":
        """Derive points from a PRG stream: candidate x values until on
        curve, even y (reference: ECqPGroup.randomElementArray try-and-
        increment derivation).

        For p = 3 (mod 4) (P-256, P-384) the candidates are processed
        in DEVICE batches — modular sqrt is rhs^((p+1)/4) — taking the
        first `nelem` valid candidates in stream order, which yields
        exactly the sequential derivation's points (the per-candidate
        host loop with a Python modpow each cost seconds per session).
        """
        if nelem == 0:
            z = jnp.zeros((0, self.L), jnp.uint32)
            return ECArray(self, z, z, jnp.zeros((0,), bool))
        bits = self.p.bit_length() + rbitlen
        nbytes = (bits + 7) // 8
        extra = 8 * nbytes - bits
        if self.p % 4 == 3 and hasattr(prg, "unread"):
            xs_parts, ys_parts, got = [], [], 0
            while got < nelem:
                k = max(2 * (nelem - got) + 16, 64)
                chunk = prg.read_bytes(k * nbytes)
                raw = np.frombuffer(
                    chunk, np.uint8
                ).reshape(k, nbytes).copy()
                if extra:
                    # the sequential derivation right-shifts the whole
                    # candidate by `extra` bits
                    wide = np.zeros((k, nbytes + 1), np.uint8)
                    wide[:, 1:] = raw
                    shifted = (
                        (wide[:, 1:] >> extra)
                        | (wide[:, :-1] << (8 - extra))
                    ).astype(np.uint8)
                    raw = shifted
                x_m, y_m, valid = self._derive_candidates(raw)
                valid = np.asarray(valid)
                idx = np.nonzero(valid)[0][: nelem - got]
                if len(idx):
                    take = jnp.asarray(idx)
                    xs_parts.append(jnp.take(x_m, take, axis=0))
                    ys_parts.append(jnp.take(y_m, take, axis=0))
                    got += len(idx)
                if got >= nelem:
                    # push the unused tail back so the stream position
                    # matches the sequential derivation exactly (a
                    # later draw from the SAME prg — e.g. the next
                    # factor of a product group — must see it)
                    consumed = int(idx[-1]) + 1
                    if consumed < k:
                        prg.unread(chunk[consumed * nbytes:])
            return ECArray(
                self,
                jnp.concatenate(xs_parts, axis=0),
                jnp.concatenate(ys_parts, axis=0),
                jnp.zeros((nelem,), bool),
            )
        pts = []
        while len(pts) < nelem:
            raw = prg.read_bytes(nbytes)
            t = int.from_bytes(raw, "big")
            if extra:
                t >>= extra
            x = t % self.p
            y = self.curve_y(x)
            if y is not None:
                if y % 2 == 1:
                    y = self.p - y
                pts.append((x, y))
        return self.from_affine(pts)

    def _derive_candidates(self, raw: np.ndarray):
        """Batched candidate evaluation (p = 3 mod 4): x = cand mod p,
        rhs = x^3 + ax + b, s = rhs^((p+1)/4), valid iff s^2 == rhs;
        y = s normalized to even (y -> p - y when odd)."""
        from vmn_tpu.arith.limbs import LIMB_BITS as _LB

        ctx = self.ctx
        c = self.curve
        Lw = max(ctx.L, num_limbs(8 * raw.shape[1]))
        wide = mont.device_limbs(bytes_be_to_limbs(raw, Lw))
        x_m = ctx.to_mont(ctx.reduce_std(wide))
        rhs = c.add(
            c.add(c.mul(c.sq(x_m), x_m),
                  c.mul(jnp.broadcast_to(c.a_m, x_m.shape), x_m)),
            jnp.broadcast_to(c.b_m, x_m.shape),
        )
        e_int = (self.p + 1) // 4
        e = jnp.asarray(int_to_limbs(e_int, ctx.L))
        s = ctx.exp(rhs, e, e_int.bit_length())
        valid = jnp.all(ctx.mul(s, s) == rhs, axis=-1)
        y_std = ctx.from_mont(s)
        odd = (y_std[..., 0] & 1).astype(bool)
        y_m = jnp.where(odd[..., None], ctx.neg(s), s)
        return x_m, y_m, valid

    # --------------------------------------------------------- serialize

    def elem_to_bytetree(self, arr: "ECArray") -> ByteTree:
        if getattr(arr, "_bt", None) is not None:
            return arr._bt
        # u16 transfer (mont.host_limbs) halves the device->host bytes
        xs = mont.host_limbs(self.ctx.from_mont(arr.x))
        ys = mont.host_limbs(self.ctx.from_mont(arr.y))
        infs = np.asarray(arr.inf)
        scalar = xs.ndim == 1
        if scalar:
            xs, ys, infs = xs[None], ys[None], infs[None]
        xb = limbs_to_bytes_be(xs, self.fbytelen)
        yb = limbs_to_bytes_be(ys, self.fbytelen)
        if infs.any():
            xb = xb.copy()
            yb = yb.copy()
            xb[infs] = 0xFF  # infinity = (-1, -1), reference encoding
            yb[infs] = 0xFF
        if scalar:
            return node(leaf(xb[0].tobytes()), leaf(yb[0].tobytes()))
        from vmn_tpu.eio.bytetree import ec_points_node

        bt = ec_points_node(xb, yb)
        arr._bt = bt
        return bt

    def _from_coord_bytes(self, xb, yb, bt, validate: bool) -> "ECArray":
        """(n, fb) big-endian coordinate bytes -> validated ECArray.

        Vectorized: infinity detection, range checks and the on-curve
        test all run batched (the test on device), replacing per-point
        Python bigint arithmetic."""
        from vmn_tpu.arith.pgroup import _range_check_be

        infs = np.logical_and(
            (xb == 0xFF).all(axis=1), (yb == 0xFF).all(axis=1)
        )
        if infs.any():
            xb = xb.copy()
            yb = yb.copy()
            xb[infs] = 0
            yb[infs] = 0
        fin_x = xb[~infs]
        fin_y = yb[~infs]
        if fin_x.size and not (
            _range_check_be(fin_x, self.p, self.fbytelen, allow_zero=True)
            and _range_check_be(fin_y, self.p, self.fbytelen,
                                allow_zero=True)
        ):
            raise ByteTreeError("EC coordinate out of range")
        ctx = self.ctx
        x_m = ctx.to_mont(
            mont.device_limbs(bytes_be_to_limbs(xb, ctx.L))
        )
        y_m = ctx.to_mont(
            mont.device_limbs(bytes_be_to_limbs(yb, ctx.L))
        )
        arr = ECArray(self, x_m, y_m, jnp.asarray(infs))
        if validate:
            from vmn_tpu.arith.pgroup import _DEFER_TLS

            hook = getattr(_DEFER_TLS, "hook", None)
            if hook is not None and xb.shape[0] >= 256:
                # Defer the on-curve check: keep the device value lazy
                # and fetch it on the membership worker, overlapped
                # with the main thread's equation dispatches (same
                # contract as the ModP deferred Jacobi path — a failed
                # check only happens on Byzantine transcripts and
                # triggers an inline re-verification).
                ok_dev = arr._on_curve_device()
                hook(lambda: bool(ok_dev))
            elif not arr.is_in_group():
                raise ByteTreeError("point not on curve")
        arr._bt = bt
        return arr

    def elem_from_bytetree(self, bt: ByteTree, size: Optional[int] = None,
                           validate: bool = True) -> "ECArray":
        from vmn_tpu.eio.bytetree import parse_ec_point_array

        # Try the raw uniform-array path BEFORE touching bt.children:
        # materializing children of a lazy RawByteTree builds one
        # object per point, which is exactly what this path avoids.
        pair = parse_ec_point_array(bt, self.fbytelen)
        if pair is not None:
            if size is not None and pair[0].shape[0] != size:
                raise ByteTreeError("wrong EC array length")
            return self._from_coord_bytes(*pair, bt, validate)
        if not bt.is_leaf and bt.children and bt.children[0].is_leaf:
            kids = [bt]  # single point node(x,y)
            scalar = True
        else:
            kids = list(bt.children)
            scalar = False
            if size is not None and len(kids) != size:
                raise ByteTreeError("wrong EC array length")
        ff = b"\xff" * self.fbytelen
        xs, ys, infs = [], [], []
        for k in kids:
            if k.is_leaf or len(k.children) != 2:
                raise ByteTreeError("malformed EC point")
            xd, yd = k[0].data, k[1].data
            if len(xd) != self.fbytelen or len(yd) != self.fbytelen:
                raise ByteTreeError("wrong EC coordinate length")
            if xd == ff and yd == ff:
                xs.append(0)
                ys.append(0)
                infs.append(True)
            else:
                x = int.from_bytes(xd, "big")
                y = int.from_bytes(yd, "big")
                if x >= self.p or y >= self.p:
                    raise ByteTreeError("EC coordinate out of range")
                if validate and (
                    (y * y - (x * x * x + self.a * x + self.b)) % self.p
                    != 0
                ):
                    raise ByteTreeError("point not on curve")
                xs.append(x)
                ys.append(y)
                infs.append(False)
        arr = ECArray(
            self,
            self.ctx.encode(xs),
            self.ctx.encode(ys),
            jnp.asarray(np.asarray(infs, bool)),
        )
        if scalar:
            p0 = arr.get(0)
            p0._bt = bt  # scalar memo: avoid a mid-pipeline device fetch
            return p0
        return arr

    def to_bytetree(self) -> ByteTree:
        from vmn_tpu.eio.bytetree import string_leaf

        return string_leaf(self.name)

    @classmethod
    def from_bytetree(cls, bt: ByteTree) -> "ECqPGroup":
        return cls.named(bt.to_string())

    # ------------------------------------------------------ msg encoding

    def encode_message(self, msg: bytes) -> tuple:
        """Try-and-increment message encoding into a point."""
        mlen = self.p.bit_length() // 8 - 4
        if len(msg) > mlen:
            raise ValueError("message too long")
        padded = len(msg).to_bytes(2, "big") + msg.ljust(mlen, b"\x00")
        base = int.from_bytes(padded, "big") << 16  # 16 bits of tries
        for t in range(1 << 16):
            x = base + t
            y = self.curve_y(x)
            if y is not None:
                return (x, min(y, self.p - y))
        raise ValueError("could not encode message")

    def decode_message(self, pt) -> bytes:
        if pt is None:
            return b""
        x = pt[0] >> 16
        mlen = self.p.bit_length() // 8 - 4
        raw = x.to_bytes(mlen + 2, "big")
        nlen = int.from_bytes(raw[:2], "big")
        if nlen > mlen:
            return b""
        return raw[2 : 2 + nlen]

    def __eq__(self, other):
        return isinstance(other, ECqPGroup) and other.name == self.name

    def __repr__(self):
        return f"ECqPGroup({self.name})"


class ECArray:
    """Array (or scalar) of EC points: affine Montgomery coords + inf
    mask.  Mirrors the GArray surface (exp = scalar mul, mul = point
    add, prod, exp_prod, ...)."""

    __slots__ = ("grp", "x", "y", "inf", "_bt")

    def spill(self) -> "ECArray":
        """Disk-spill backend hook (arrays=file)."""
        from vmn_tpu.arith import storage

        return ECArray(self.grp, storage.maybe_spill(self.x),
                       storage.maybe_spill(self.y),
                       storage.maybe_spill(self.inf))

    def __init__(self, grp: ECqPGroup, x, y, inf):
        self.grp = grp
        self.x = x
        self.y = y
        self.inf = inf
        self._bt = None  # serialization memo (set by the codec paths)

    # -------------------------------------------------------------- meta

    @property
    def shape(self):
        return self.x.shape[:-1]

    @property
    def size(self) -> int:
        return int(self.x.shape[0])

    def __len__(self):
        return self.size

    def get(self, i: int) -> "ECArray":
        return ECArray(self.grp, self.x[i], self.y[i], self.inf[i])

    def copy_of_range(self, a: int, b: int) -> "ECArray":
        return ECArray(
            self.grp, self.x[a:b], self.y[a:b], self.inf[a:b]
        )

    def broadcast(self, n: int) -> "ECArray":
        return ECArray(
            self.grp,
            jnp.broadcast_to(self.x, (n,) + self.x.shape),
            jnp.broadcast_to(self.y, (n,) + self.y.shape),
            jnp.broadcast_to(self.inf, (n,) + self.inf.shape),
        )

    def to_affine(self):
        return self.grp.to_affine(self)

    # --------------------------------------------------------------- ops

    def _jac(self):
        c = self.grp.curve
        Z = jnp.broadcast_to(c.one_m, self.x.shape)
        Z = _select(self.inf, jnp.zeros_like(Z), Z)
        return self.x, self.y, Z

    def mul(self, other: "ECArray") -> "ECArray":
        c = self.grp.curve
        X1, Y1, Z1 = self._jac()
        X2, Y2, Z2 = other._jac()
        shape = jnp.broadcast_shapes(X1.shape, X2.shape)
        X1, Y1, Z1, X2, Y2, Z2 = (
            jnp.broadcast_to(t, shape) for t in (X1, Y1, Z1, X2, Y2, Z2)
        )
        x, y, inf = c.normalize(*c.point_add(X1, Y1, Z1, X2, Y2, Z2))
        return ECArray(self.grp, x, y, inf)

    def inv(self) -> "ECArray":
        c = self.grp.curve
        return ECArray(
            self.grp, self.x,
            mont.sub_mod(
                jnp.zeros_like(self.y), self.y, c.ctx.m_limbs
            ),
            self.inf,
        )

    def div(self, other: "ECArray") -> "ECArray":
        return self.mul(other.inv())

    def exp(self, e) -> "ECArray":
        if isinstance(e, int):
            e = self.grp.ring.from_int(e)
        return self._exp_impl(e.limbs, self.grp.ring.nbits)

    def exp_bits(self, e, nbits: int) -> "ECArray":
        # Clamp to the exponent's own representation: digits past its
        # last limb would be read via CLAMPED dynamic slices (JAX
        # semantics), silently producing wrong scalars — hit when
        # ebitlen (256) exceeds the curve-order size (224 for P-224).
        from vmn_tpu.arith.limbs import LIMB_BITS

        nbits = min(nbits, LIMB_BITS * e.limbs.shape[-1])
        return self._exp_impl(e.limbs, nbits)

    def _exp_impl(self, e_limbs, nbits: int) -> "ECArray":
        c = self.grp.curve
        x, y, inf = _scalar_mul(c, self.x, self.y, self.inf, e_limbs, nbits)
        return ECArray(self.grp, x, y, inf)

    def exp_prod(self, e, nbits: Optional[int] = None) -> "ECArray":
        """Simultaneous multi-exponentiation sum_i e_i * P_i
        (reference: PGroupElementArray.expProd via gmpmee/vec spowm):
        per-element scalar multiplication and an addition tree."""
        nbits = self.grp.ring.nbits if nbits is None else nbits
        nbits = min(nbits, LIMB_BITS * e.limbs.shape[-1])
        powers = self.exp_bits(e, nbits)
        return powers.prod()

    def exp_mul(self, v, other: "ECArray") -> "ECArray":
        return self.exp(v).mul(other)

    def prod(self) -> "ECArray":
        c = self.grp.curve
        X, Y, Z = self._jac()
        while X.shape[0] > 1:
            nel = X.shape[0]
            h = nel // 2
            aX, aY, aZ = c.point_add(
                X[:h], Y[:h], Z[:h], X[h : 2 * h], Y[h : 2 * h],
                Z[h : 2 * h],
            )
            if nel % 2:
                aX = jnp.concatenate([aX, X[2 * h :]], axis=0)
                aY = jnp.concatenate([aY, Y[2 * h :]], axis=0)
                aZ = jnp.concatenate([aZ, Z[2 * h :]], axis=0)
            X, Y, Z = aX, aY, aZ
        x, y, inf = c.normalize(X[0], Y[0], Z[0])
        return ECArray(self.grp, x, y, inf)

    def permute(self, pi) -> "ECArray":
        return self.take(pi.tbl)

    def take(self, idx) -> "ECArray":
        return ECArray(
            self.grp,
            jnp.take(self.x, idx, axis=0),
            jnp.take(self.y, idx, axis=0),
            jnp.take(self.inf, idx, axis=0),
        )

    def shift_push(self, first: "ECArray") -> "ECArray":
        return ECArray(
            self.grp,
            jnp.concatenate(
                [jnp.broadcast_to(first.x, (1, self.grp.L)), self.x[:-1]],
                axis=0,
            ),
            jnp.concatenate(
                [jnp.broadcast_to(first.y, (1, self.grp.L)), self.y[:-1]],
                axis=0,
            ),
            jnp.concatenate(
                [jnp.broadcast_to(first.inf, (1,)), self.inf[:-1]], axis=0
            ),
        )

    def concat(self, other: "ECArray") -> "ECArray":
        return ECArray(
            self.grp,
            jnp.concatenate([self.x, other.x], axis=0),
            jnp.concatenate([self.y, other.y], axis=0),
            jnp.concatenate([self.inf, other.inf], axis=0),
        )

    def equals(self, other: "ECArray") -> bool:
        return bool(
            jnp.array_equal(self.x, other.x)
            and jnp.array_equal(self.y, other.y)
            and jnp.array_equal(self.inf, other.inf)
        )

    def _on_curve_device(self):
        """y^2 == x^3 + ax + b for all non-infinity points, as a LAZY
        device scalar (no host sync)."""
        c = self.grp.curve
        y2 = c.sq(self.y)
        x3 = c.mul(c.sq(self.x), self.x)
        rhs = c.add(
            c.add(x3, c.mul(jnp.broadcast_to(c.a_m, self.x.shape), self.x)),
            jnp.broadcast_to(c.b_m, self.x.shape),
        )
        on = jnp.all(y2 == rhs, axis=-1)
        ok = jnp.logical_or(on, self.inf)
        return jnp.all(ok)

    def is_in_group(self) -> bool:
        """On-curve test for all points (cofactor 1 on all NIST curves,
        so on-curve implies in-group)."""
        return bool(self._on_curve_device())

    def to_bytetree(self) -> ByteTree:
        return self.grp.elem_to_bytetree(self)

    def __repr__(self):
        return f"ECArray(shape={self.shape}, {self.grp})"


# ====================================================================
# NIST curves (reference: demo/mixnet/.conf group notes name P-224,
# P-256, P-521 as the native-accelerated curves)
# ====================================================================

from vmn_tpu.eio.marshal import register as _register  # noqa: E402

_register(ECqPGroup.MARSHAL_NAME)(ECqPGroup)

_CURVES = {
    "P-224": (
        int("ffffffffffffffffffffffffffffffff000000000000000000000001", 16),
        -3,
        int("b4050a850c04b3abf54132565044b0b7d7bfd8ba270b39432355ffb4", 16),
        int("b70e0cbd6bb4bf7f321390b94a03c1d356c21122343280d6115c1d21", 16),
        int("bd376388b5f723fb4c22dfe6cd4375a05a07476444d5819985007e34", 16),
        int("ffffffffffffffffffffffffffff16a2e0b8f03e13dd29455c5c2a3d", 16),
    ),
    "P-256": (
        int("ffffffff00000001000000000000000000000000ffffffffffffffff"
            "ffffffff", 16),
        -3,
        int("5ac635d8aa3a93e7b3ebbd55769886bc651d06b0cc53b0f63bce3c3e"
            "27d2604b", 16),
        int("6b17d1f2e12c4247f8bce6e563a440f277037d812deb33a0f4a13945"
            "d898c296", 16),
        int("4fe342e2fe1a7f9b8ee7eb4a7c0f9e162bce33576b315ececbb64068"
            "37bf51f5", 16),
        int("ffffffff00000000ffffffffffffffffbce6faada7179e84f3b9cac2"
            "fc632551", 16),
    ),
    "P-384": (
        (1 << 384) - (1 << 128) - (1 << 96) + (1 << 32) - 1,
        -3,
        int("b3312fa7e23ee7e4988e056be3f82d19181d9c6efe8141120314088f5013"
            "875ac656398d8a2ed19d2a85c8edd3ec2aef", 16),
        int("aa87ca22be8b05378eb1c71ef320ad746e1d3b628ba79b9859f741e08254"
            "2a385502f25dbf55296c3a545e3872760ab7", 16),
        int("3617de4a96262c6f5d9e98bf9292dc29f8f41dbd289a147ce9da3113b5f0"
            "b8c00a60b1ce1d7e819d7a431d7c90ea0e5f", 16),
        int("ffffffffffffffffffffffffffffffffffffffffffffffffc7634d81f43"
            "72ddf581a0db248b0a77aecec196accc52973", 16),
    ),
    "P-521": (
        (1 << 521) - 1,
        -3,
        int("0051953eb9618e1c9a1f929a21a0b68540eea2da725b99b315f3b8b4899"
            "18ef109e156193951ec7e937b1652c0bd3bb1bf073573df883d2c34f1ef"
            "451fd46b503f00", 16),
        int("00c6858e06b70404e9cd9e3ecb662395b4429c648139053fb521f828af6"
            "06b4d3dbaa14b5e77efe75928fe1dc127a2ffa8de3348b3c1856a429bf9"
            "7e7e31c2e5bd66", 16),
        int("011839296a789a3bc0045c8a5fb42c7d1bd998f54449579b446817afbd1"
            "7273e662c97ee72995ef42640c550b9013fad0761353c7086a272c24088"
            "be94769fd16650", 16),
        int("01fffffffffffffffffffffffffffffffffffffffffffffffffffffffff"
            "ffffffffa51868783bf2f966b7fcc0148f709a5d03bb5c9b8899c47aebb"
            "6fb71e91386409", 16),
    ),
}
