"""Batched Montgomery arithmetic over multi-limb integers (JAX/XLA).

This is the device compute core replacing the reference's GMP/gmpmee native
layer (reference: SURVEY.md §2.3 — modular exponentiation, simultaneous
multi-exponentiation `prod b_i^{e_i}` used 23x e.g. PoSBasicTW.java:408-409,
fixed-base exponentiation used by `g.exp(array)` 91x).

Design:
  * elements are ``(..., L)`` uint32 tensors of 16-bit limbs (see limbs.py);
    the batch axis N (ciphertexts) shards across the device mesh;
  * Montgomery multiplication is CIOS with lazy carries: the inner loop
    accumulates 16-bit partial products in 32-bit lanes (<=2^25 after 128
    iterations) and resolves carries once per multiplication with an exact
    scan that simultaneously performs the conditional final subtraction —
    inputs and outputs are always canonical (< m);
  * exponentiation is fixed-window (w=4) square-and-multiply over the batch
    — no data-dependent control flow, identical schedule for every element;
  * fixed-base exponentiation uses precomputed radix-2^8 tables shared
    across the batch (the gmpmee fixed-base equivalent);
  * simultaneous multi-exponentiation shares the squarings across the
    batch (Straus here; digit positions in the CUDA core).

Shape and size choose the algorithm on every platform; the platform
chooses the kernel (`_use_core`): on the GPU the CUDA Montgomery core in
`vmn_tpu.ops.core` serves the products, exponentiations and
multi-exponentiations, elsewhere the portable XLA code in this module.
Both are exact, so their results are bit-identical.
"""

from __future__ import annotations

import collections
import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from vmn_tpu.arith.limbs import (
    LIMB_BITS,
    LIMB_MASK,
    int_to_limbs,
    ints_to_limbs,
    limbs_to_int,
    num_limbs,
)
from vmn_tpu.ops import core

# ----------------------------------------------------------------- helpers


def _broadcast_pair(a, b):
    shape = jnp.broadcast_shapes(a.shape, b.shape)
    return jnp.broadcast_to(a, shape), jnp.broadcast_to(b, shape)


def _finalize(t, m):
    """Normalize lazy limbs and conditionally subtract the modulus.

    t: (..., L+1) uint32 lazy limbs (each < 2^26) holding a value in [0, 2m).
    m: (L,) uint32 canonical modulus limbs.
    Returns canonical (..., L) uint32 with value = t mod m' semantics
    (t if t < m else t - m).
    """
    L = m.shape[-1]
    mp = jnp.concatenate([m, jnp.zeros((1,), jnp.uint32)]).astype(jnp.int32)
    tt = jnp.moveaxis(t, -1, 0).astype(jnp.int32)  # (L+1, ...)
    mm = jnp.broadcast_to(mp.reshape((L + 1,) + (1,) * (tt.ndim - 1)), tt.shape)

    zeros = jnp.zeros(tt.shape[1:], jnp.int32)

    def step(state, xs):
        carry, borrow = state
        tk, mk = xs
        s = tk + carry
        lo = s & LIMB_MASK
        carry = s >> LIMB_BITS
        d = lo - mk - borrow
        dlo = d & LIMB_MASK
        borrow = (d >> 31) & 1
        return (carry, borrow), (lo, dlo)

    (_, borrow), (lo, dlo) = jax.lax.scan(step, (zeros, zeros), (tt, mm))
    res = jnp.where(borrow[None].astype(bool), lo, dlo)
    return jnp.moveaxis(res, 0, -1)[..., :L].astype(jnp.uint32)


def _mont_mul(a, b, m, mprime):
    """CIOS Montgomery product a*b*R^{-1} mod m; inputs canonical (..., L)."""
    a, b = _broadcast_pair(a, b)
    L = m.shape[-1]
    t = jnp.zeros(a.shape[:-1] + (L + 1,), jnp.uint32)

    def body(i, t):
        ai = jax.lax.dynamic_slice_in_dim(a, i, 1, axis=-1)  # (..., 1)
        p = ai * b
        t = t.at[..., :L].add(p & LIMB_MASK)
        t = t.at[..., 1:].add(p >> LIMB_BITS)
        q = ((t[..., 0] * mprime) & LIMB_MASK)[..., None]
        p2 = q * m
        t = t.at[..., :L].add(p2 & LIMB_MASK)
        t = t.at[..., 1:].add(p2 >> LIMB_BITS)
        carry = t[..., 0] >> LIMB_BITS
        t = jnp.concatenate(
            [t[..., 1:], jnp.zeros_like(t[..., :1])], axis=-1
        )
        t = t.at[..., 0].add(carry)
        return t

    t = jax.lax.fori_loop(0, L, body, t)
    return _finalize(t, m)


def _sub_borrow(a, b):
    """Exact limbwise a - b: returns (diff mod 2^(16L), borrow (...,))."""
    a, b = _broadcast_pair(a, b)
    aa = jnp.moveaxis(a, -1, 0).astype(jnp.int32)
    bb = jnp.moveaxis(b, -1, 0).astype(jnp.int32)
    zeros = jnp.zeros(aa.shape[1:], jnp.int32)

    def step(borrow, xs):
        ak, bk = xs
        d = ak - bk - borrow
        return (d >> 31) & 1, d & LIMB_MASK

    borrow, d = jax.lax.scan(step, zeros, (aa, bb))
    return jnp.moveaxis(d, 0, -1).astype(jnp.uint32), borrow


def _add_carry(a, b):
    """Exact limbwise a + b mod 2^(16L) (carry out dropped)."""
    a, b = _broadcast_pair(a, b)
    aa = jnp.moveaxis(a, -1, 0)
    bb = jnp.moveaxis(b, -1, 0)
    zeros = jnp.zeros(aa.shape[1:], jnp.uint32)

    def step(carry, xs):
        ak, bk = xs
        s = ak + bk + carry
        return s >> LIMB_BITS, s & LIMB_MASK

    _, s = jax.lax.scan(step, zeros, (aa, bb))
    return jnp.moveaxis(s, 0, -1)


# ------------------------------------------------------------- jitted ops


@jax.jit
def mont_mul(a, b, m, mprime):
    return _mont_mul(a, b, m, mprime)


@jax.jit
def add_mod(a, b, m):
    """(a + b) mod m for canonical a, b < m."""
    s = a + b  # limbs <= 2^17, lazy
    a_, s_ = _broadcast_pair(a, s)
    t = jnp.concatenate([s_, jnp.zeros_like(s_[..., :1])], axis=-1)
    return _finalize(t, m)


@jax.jit
def sub_mod(a, b, m):
    """(a - b) mod m for canonical a, b < m."""
    d, borrow = _sub_borrow(a, b)
    mb = jnp.broadcast_to(m, d.shape)
    d_plus_m = _add_carry(d, mb)
    return jnp.where(borrow[..., None].astype(bool), d_plus_m, d)


@jax.jit
def is_lt(a, b):
    """a < b limbwise big-int compare -> bool (...,)."""
    _, borrow = _sub_borrow(a, b)
    return borrow.astype(bool)


_WINDOW = 4


def _digit(e, j):
    """Extract 4-bit digit j (traced) from (..., Le) exponent limbs."""
    limb = j // (LIMB_BITS // _WINDOW)
    shift = (j % (LIMB_BITS // _WINDOW)) * _WINDOW
    el = jax.lax.dynamic_slice_in_dim(e, limb, 1, axis=-1)[..., 0]
    return (el >> shift) & ((1 << _WINDOW) - 1)


@functools.partial(jax.jit, static_argnames=("nbits",))
def mont_exp(base, e, m, mprime, one_mont, nbits: int):
    """base^e in Montgomery form, fixed 4-bit windows.

    base: (..., L) Montgomery-form canonical.  e: (..., Le) standard-form
    limbs.  Every element follows the identical schedule (no data-dependent
    branching): digits select table entries with gathers.
    """
    L = m.shape[-1]
    shape = jnp.broadcast_shapes(base.shape[:-1], e.shape[:-1])
    base = jnp.broadcast_to(base, shape + (L,))
    e = jnp.broadcast_to(e, shape + e.shape[-1:])
    # Digits past e's last limb must read as zero (dynamic slices clamp,
    # which would repeat the top limb when nbits > 16*Le).
    need_limbs = ((nbits + _WINDOW - 1) // _WINDOW * _WINDOW
                  + LIMB_BITS - 1) // LIMB_BITS
    if e.shape[-1] < need_limbs:
        pad = jnp.zeros(shape + (need_limbs - e.shape[-1],), jnp.uint32)
        e = jnp.concatenate([e, pad], axis=-1)

    one = jnp.broadcast_to(one_mont, shape + (L,))

    # Table of base^d for d in [0, 16), built with a scan so the body
    # is traced once (compile-time matters: this graph nests in every
    # group operation).
    def tbl_step(prev, _):
        nxt = _mont_mul(prev, base, m, mprime)
        return nxt, nxt

    _, tail = jax.lax.scan(
        tbl_step, base, None, length=(1 << _WINDOW) - 2
    )
    table = jnp.concatenate(
        [one[None], base[None], tail], axis=0
    )  # (16, ..., L)

    ndig = (nbits + _WINDOW - 1) // _WINDOW

    def body(k, acc):
        j = ndig - 1 - k
        acc = jax.lax.fori_loop(
            0, _WINDOW, lambda _, a: _mont_mul(a, a, m, mprime), acc
        )
        dig = _digit(e, j)
        idx = jnp.broadcast_to(
            dig[None, ..., None].astype(jnp.int32), (1,) + shape + (L,)
        )
        fac = jnp.take_along_axis(table, idx, axis=0)[0]
        return _mont_mul(acc, fac, m, mprime)

    return jax.lax.fori_loop(0, ndig, body, one)


def _use_core(L: int) -> bool:
    """Kernel choice: the CUDA Montgomery core on the GPU, XLA's
    `_mont_mul` everywhere else.  A width the core has no build for runs
    XLA on the GPU too, with a warning (`core.WIDTHS`)."""
    if jax.default_backend() != "gpu":
        return False
    if core.supports(L):
        return True
    _warn_no_core(L)
    return False


@functools.lru_cache(maxsize=None)
def _warn_no_core(L: int) -> None:
    import warnings

    warnings.warn(
        f"the Montgomery core has no build for {16 * L}-bit moduli "
        f"({(L + 1) // 2} words; built: {core.WIDTHS}): this width runs "
        f"XLA's product loop on the GPU, which is orders of magnitude "
        f"slower", RuntimeWarning, stacklevel=3)


def _mul_dispatch(a, b, m, mprime):
    """Montgomery product usable inside jit: the core on the GPU, XLA
    otherwise.  a, b: (N, L) canonical limbs (same shape)."""
    if a.ndim == 2 and a.shape[0] > 0 and _use_core(m.shape[-1]):
        return core.mont_mul(a, b, m)
    return _mont_mul(a, b, m, mprime)


@jax.jit
def _prod_tree(x, m, mprime, one_mont):
    """Log-depth product over axis 0 — ONE compiled program per shape.

    (The previous implementation dispatched one separately-jitted
    Montgomery product per tree level, compiling a fresh XLA program for
    every intermediate shape — 2·log2(N) compilations per array size and
    a host round-trip per level.)
    """
    n = x.shape[0]
    if n == 1:
        return x[0]
    # pad to a power of two with the multiplicative identity
    p2 = 1 << (n - 1).bit_length()
    if p2 != n:
        pad = jnp.broadcast_to(one_mont, (p2 - n,) + x.shape[1:])
        x = jnp.concatenate([x, pad], axis=0)
    while x.shape[0] > 1:
        h = x.shape[0] // 2
        x = _mul_dispatch(x[:h], x[h:], m, mprime)
    return x[0]


@jax.jit
def _prods_scan(x, m, mprime, one_mont):
    """Inclusive cumulative Montgomery product over axis 0.

    Hillis–Steele over full-size arrays: log2(N) batched products inside
    a single compiled program (an associative scan of XLA products
    compiled minutes-long programs).
    """
    n = x.shape[0]
    d = 1
    while d < n:
        pad = jnp.broadcast_to(one_mont, (d,) + x.shape[1:])
        shifted = jnp.concatenate([pad, x[:-d]], axis=0)
        x = _mul_dispatch(x, shifted, m, mprime)
        d *= 2
    return x


@jax.jit
def _rec_lin_scan(mm, aa, m, mprime, one_mont):
    """Affine-recurrence scan x_i = x_{i-1}·e_i + b_i over axis 0.

    mm: (N, L) multipliers in Montgomery form; aa: (N, L) addends in
    standard form.  Composition of affine maps (m1,a1)∘(m2,a2) =
    (m1·m2, a1·m2 + a2), Hillis–Steele.  Returns standard-form x.
    """
    n = mm.shape[0]
    d = 1
    while d < n:
        pad_m = jnp.broadcast_to(one_mont, (d,) + mm.shape[1:])
        pad_a = jnp.zeros((d,) + aa.shape[1:], aa.dtype)
        m_sh = jnp.concatenate([pad_m, mm[:-d]], axis=0)
        a_sh = jnp.concatenate([pad_a, aa[:-d]], axis=0)
        new_m = _mul_dispatch(m_sh, mm, m, mprime)
        new_a = add_mod(_mul_dispatch(a_sh, mm, m, mprime), aa, m)
        mm, aa = new_m, new_a
        d *= 2
    return aa


@functools.partial(jax.jit, static_argnames=("nbits",))
def _expprod_shared(bases, e, m, mprime, one_mont, nbits: int):
    """Simultaneous multi-exponentiation prod_i bases_i^{e_i} with
    SHARED squarings (Straus interleaving).

    The naive expprod (per-element windowed exp + product tree) costs
    ~(nbits + nbits/4)·N products; here the accumulator is a single
    element squared once per bit, so the cost is ~(14 + nbits/4)·N —
    ~5x less for full-size exponents, ~4x for 256-bit batching vectors.
    This is the honest gmpmee `spowm` analogue (reference: SURVEY.md
    §2.3), restructured so the per-digit batch product is a log-depth
    tree of batched products instead of a sequential loop.

    bases: (N, L) Montgomery form; e: (N, Le) standard limbs with
    values < 2^nbits.  Returns (L,) Montgomery form.
    """
    N, L = bases.shape
    W = _WINDOW
    digits_per_limb = LIMB_BITS // W
    ndig = max(1, (nbits + W - 1) // W)
    need_limbs = (ndig * W + LIMB_BITS - 1) // LIMB_BITS
    if e.shape[1] < need_limbs:
        e = jnp.concatenate(
            [e, jnp.zeros((N, need_limbs - e.shape[1]), jnp.uint32)], axis=1
        )

    # Pad the batch to a power of two with the identity.
    p2 = 1 << (N - 1).bit_length()
    if p2 != N:
        pad_b = jnp.broadcast_to(one_mont, (p2 - N, L))
        bases = jnp.concatenate([bases, pad_b], axis=0)
        e = jnp.concatenate(
            [e, jnp.zeros((p2 - N, e.shape[1]), jnp.uint32)], axis=0
        )

    # Power table T[d] = bases^d, d in [0, 16): (16, Np, L).
    rows = [jnp.broadcast_to(one_mont, bases.shape), bases]
    for _ in range(2, 1 << W):
        rows.append(_mul_dispatch(rows[-1], bases, m, mprime))
    T = jnp.stack(rows)

    one_row = jnp.broadcast_to(one_mont, (1, L))

    def body(k, acc):
        j = ndig - 1 - k
        # W squarings of the single accumulator (XLA path: scalar-sized)
        for _ in range(W):
            acc = _mont_mul(acc, acc, m, mprime)
        limb = j // digits_per_limb
        shift = (j % digits_per_limb) * W
        el = jax.lax.dynamic_slice_in_dim(e, limb, 1, axis=1)[:, 0]
        dig = ((el >> shift) & ((1 << W) - 1)).astype(jnp.int32)
        sel = jnp.take_along_axis(
            T, dig[None, :, None], axis=0
        )[0]  # (Np, L)
        # Batch product: log-depth tree of batched products.
        while sel.shape[0] > 1:
            h = sel.shape[0] // 2
            sel = _mul_dispatch(sel[:h], sel[h:], m, mprime)
        return _mont_mul(acc, sel, m, mprime)

    acc = jax.lax.fori_loop(0, ndig, body, one_row)
    return acc[0]


_SCAN_CHUNK_N = 1 << 18  # chunk Hillis-Steele scans above this size
_SCAN_CHUNK = 1 << 16


def _prods_scan_chunked(x, m, mprime, one_mont):
    """Sequentially chunked cumulative product for huge batches.

    The one-jit Hillis-Steele scan can hold every round's buffers when
    the products are custom calls (XLA does not reuse buffers across
    them): ~20 rounds x 4 arrays = ~10 GB internal peak at N=2^20 on top
    of the protocol's live set.  Chunks of 2^16 bound the peak; the carry
    composes chunk k into chunk k+1 with one broadcast product.  A tiny
    fetch per chunk drains the queue.
    """
    outs = []
    carry = None  # (L,) Montgomery form
    for s in range(0, x.shape[0], _SCAN_CHUNK):
        part = _prods_scan(x[s : s + _SCAN_CHUNK], m, mprime, one_mont)
        if carry is not None:
            part = _mul_dispatch(
                part, jnp.broadcast_to(carry, part.shape), m, mprime,
            )
        carry = part[-1]
        np.asarray(part[:1, :1])  # drain (see `backpressure`)
        outs.append(part)
    return jnp.concatenate(outs, axis=0)


def _rec_lin_chunked(mm, aa, m, mprime, one_mont):
    """Sequentially chunked affine-recurrence scan (see
    _prods_scan_chunked).  Chunk-to-chunk composition mirrors the
    sharded mesh wrapper: x = A_loc + x_in * M_pref per chunk."""
    outs = []
    x_in = None  # (L,) standard form
    for s in range(0, mm.shape[0], _SCAN_CHUNK):
        mmc = mm[s : s + _SCAN_CHUNK]
        aac = aa[s : s + _SCAN_CHUNK]
        a_loc = _rec_lin_scan(mmc, aac, m, mprime, one_mont)
        if x_in is not None:
            m_pref = _prods_scan(mmc, m, mprime, one_mont)
            a_loc = add_mod(
                _mont_mul(m_pref, x_in[None, :], m, mprime), a_loc, m
            )
        x_in = a_loc[-1]
        np.asarray(a_loc[:1, :1])  # drain
        outs.append(a_loc)
    return jnp.concatenate(outs, axis=0)


def _expprod_fast(bases, e, m, mprime, one_mont, nbits: int):
    """Shared-squaring multi-exp of an (N, L) batch: digit positions in
    the CUDA core on the GPU, Straus with a product tree in XLA
    otherwise."""
    if _use_core(m.shape[-1]):
        return core.expprod(bases, e, m, one_mont, nbits)
    return _expprod_shared(bases, e, m, mprime, one_mont, nbits)


def _positions_fast(bases, e, m, mprime, one_mont, nbits: int):
    """Per-digit-position products of an (N, L) batch (see
    `_expprod_positions`): the core on the GPU, XLA otherwise."""
    if _use_core(m.shape[-1]):
        return core.expprod_positions(bases, e, m, one_mont, nbits)
    return _expprod_positions(bases, e, m, mprime, one_mont, nbits)


@functools.partial(jax.jit, static_argnames=("nbits",))
def _expprod_positions(bases, e, m, mprime, one_mont, nbits: int):
    """Per-digit-position products P_j = prod_i bases_i^{d_ij} where
    e_i = sum_j 16^j d_ij -> (ceil(nbits / 4), L) Montgomery form.

    With uniform digits each P_j's Legendre symbol is an independent
    coin that lands -1 with probability 1/2 when ANY base is a
    non-residue (the batched QR test of `ModPGroup`)."""
    N, L = bases.shape
    W = _WINDOW
    ndig = max(1, (nbits + W - 1) // W)
    need_limbs = (ndig * W + LIMB_BITS - 1) // LIMB_BITS
    if e.shape[1] < need_limbs:
        e = jnp.concatenate(
            [e, jnp.zeros((N, need_limbs - e.shape[1]), jnp.uint32)], axis=1
        )
    rows = [jnp.broadcast_to(one_mont, bases.shape), bases]
    for _ in range(2, 1 << W):
        rows.append(_mul_dispatch(rows[-1], bases, m, mprime))
    T = jnp.stack(rows)  # (16, N, L)

    def position(j):
        dig = _digit(e, j).astype(jnp.int32)
        sel = jnp.take_along_axis(T, dig[None, :, None], axis=0)[0]
        return _prod_tree(sel, m, mprime, one_mont)

    return jax.lax.map(position, jnp.arange(ndig))


@functools.partial(jax.jit, static_argnames=("entries",))
def _fb_table_scan(bases, m, mprime, one_mont, entries: int):
    """Fixed-base window table on device: T[j, d] = bases_j^d.

    bases: (J, L) Montgomery form — base^(2^(W·j)) per digit position.
    Returns (J, entries, L) Montgomery form.  One compiled scan of
    `entries-2` batched Montgomery products replaces the former host
    Python loop (J·entries bignum modmuls + J·entries int_to_limbs —
    ~2.3 s per base at 2048 bits, paid per session for the h0 table)."""
    J, L = bases.shape
    one = jnp.broadcast_to(one_mont, (J, L))

    def step(carry, _):
        nxt = _mul_dispatch(carry, bases, m, mprime)
        return nxt, nxt

    if entries <= 2:
        parts = [one[None], bases[None]][:entries]
        return jnp.transpose(jnp.concatenate(parts, axis=0), (1, 0, 2))
    _, rest = jax.lax.scan(step, bases, None, length=entries - 2)
    tbl = jnp.concatenate([one[None], bases[None], rest], axis=0)
    return jnp.transpose(tbl, (1, 0, 2))


@functools.partial(jax.jit)
def _sum_tree(x, m):
    """Log-depth modular sum over axis 0 in one compiled program."""
    n = x.shape[0]
    if n == 1:
        return x[0]
    p2 = 1 << (n - 1).bit_length()
    if p2 != n:
        pad = jnp.zeros((p2 - n,) + x.shape[1:], x.dtype)
        x = jnp.concatenate([x, pad], axis=0)
    while x.shape[0] > 1:
        h = x.shape[0] // 2
        x = add_mod(x[:h], x[h:], m)
    return x[0]


def prod_reduce(x, m, mprime, axis=0):
    """Log-depth product tree along `axis` with Montgomery products."""
    x = jnp.moveaxis(x, axis, 0)
    while x.shape[0] > 1:
        n = x.shape[0]
        h = n // 2
        lo = _mont_mul(x[:h], x[h : 2 * h], m, mprime)
        x = jnp.concatenate([lo, x[2 * h :]], axis=0) if n % 2 else lo
    return x[0]


@functools.partial(jax.jit, static_argnames=("nbits",))
def mont_expprod(bases, e, m, mprime, one_mont, nbits: int):
    """Simultaneous multi-exponentiation prod_i bases_i^{e_i} over axis 0.

    The gmpmee `spowm` equivalent (reference: SURVEY.md §2.3): batched
    windowed exponentiation followed by a log-depth product reduction.
    """
    powers = mont_exp(bases, e, m, mprime, one_mont, nbits)
    return prod_reduce(powers, m, mprime, axis=0)


@functools.partial(jax.jit, static_argnames=("ndig", "fb_window"))
def _fixed_base_exp(table, e, m, mprime, one_mont, ndig: int, fb_window: int):
    """prod_j table[j][digit_j(e)] — shared-base exponentiation.

    table: (J, 2^w, L) Montgomery form.  e: (..., Le) standard limbs.
    """
    L = m.shape[-1]
    shape = e.shape[:-1]
    # zero-pad e so digit reads never clamp at the top limb
    need_limbs = (ndig * fb_window + LIMB_BITS - 1) // LIMB_BITS
    if e.shape[-1] < need_limbs:
        pad = jnp.zeros(shape + (need_limbs - e.shape[-1],), jnp.uint32)
        e = jnp.concatenate([e, pad], axis=-1)
    acc = jnp.broadcast_to(one_mont, shape + (L,))
    digits_per_limb = LIMB_BITS // fb_window
    dig_mask = (1 << fb_window) - 1

    def body(j, acc):
        limb = j // digits_per_limb
        shift = (j % digits_per_limb) * fb_window
        el = jax.lax.dynamic_slice_in_dim(e, limb, 1, axis=-1)[..., 0]
        dig = (el >> shift) & dig_mask
        row = jax.lax.dynamic_slice_in_dim(table, j, 1, axis=0)[0]  # (2^w, L)
        fac = row[dig.astype(jnp.int32)]  # (..., L)
        return _mont_mul(acc, fac, m, mprime)

    return jax.lax.fori_loop(0, ndig, body, acc)


# ------------------------------------------------- host<->device limbs
# Limb values are 16-bit; moving them as uint16 HALVES host<->device
# transfer volume (significant over PCIe when N is large),
# widening/narrowing on-device.


@jax.jit
def _widen_u16(a):
    return a.astype(jnp.uint32)


@jax.jit
def _narrow_u16(a):
    return a.astype(jnp.uint16)


def device_limbs(arr) -> jnp.ndarray:
    """Host limb array (any uint dtype) -> device uint32 limbs."""
    arr = np.asarray(arr)
    if arr.dtype != np.uint16:
        arr = arr.astype(np.uint16)
    return _widen_u16(jnp.asarray(arr))


_BACKPRESSURE_N = 1 << 18


def backpressure(*arrays) -> None:
    """Drain the device queue at phase boundaries for huge batches.

    JAX allocates every dispatched op's output at ENQUEUE time; a whole
    mix phase dispatched ahead of execution at N = 2^20 (512 MB per
    2048-bit array) transiently holds tens of GB.  A one-element fetch
    waits for all queued work (in-order execution), letting dead
    intermediate buffers free.  No-op below 2^18 elements; costs one
    device round-trip above."""
    for a in arrays:
        if hasattr(a, "components"):
            backpressure(*a.components)
            continue
        limbs = getattr(a, "limbs", None)
        if limbs is None:
            limbs = getattr(a, "x", a)  # ECArray coordinate
        if (
            hasattr(limbs, "ndim")
            and limbs.ndim >= 2
            and limbs.shape[0] >= _BACKPRESSURE_N
        ):
            np.asarray(limbs[:1, :1])
            return


def host_limbs(x) -> np.ndarray:
    """Device uint32 limbs -> host uint16 array (half the transfer).

    Multi-process: a global array sharded across hosts is not fully
    addressable locally — gather it first (every process gets the full
    value, which the SPMD protocol layer requires anyway for transcript
    serialization and challenge hashing)."""
    y = _narrow_u16(x)
    if isinstance(y, jax.Array) and not y.is_fully_addressable:
        from jax.experimental import multihost_utils

        return np.asarray(multihost_utils.process_allgather(y, tiled=True))
    return np.asarray(y)


# ------------------------------------------------------ sharded dispatch


def shard_info(*arrays):
    """(mesh, axis) when an operand's batch axis is sharded over >1
    device — the signal to route through the shard_map-wrapped core
    calls in `parallel.mesh` (an FFI call cannot be GSPMD-partitioned
    like plain XLA ops).

    Only concrete (non-traced) 2-D (N, L) operands with axis 0 mapped
    to a mesh axis count; inside an outer jit the tracers fall back to
    the caller's path.
    """
    from jax.sharding import NamedSharding

    for a in arrays:
        if isinstance(a, jax.core.Tracer) or not isinstance(a, jax.Array):
            continue
        sh = getattr(a, "sharding", None)
        if not isinstance(sh, NamedSharding) or sh.mesh.size <= 1:
            continue
        if a.ndim < 2 or len(sh.spec) < 1 or sh.spec[0] is None:
            continue
        ax = sh.spec[0]
        if isinstance(ax, tuple):
            if len(ax) != 1:
                continue
            ax = ax[0]
        return sh.mesh, ax
    return None


def _as_rows(x, shape, lone_row_ok: bool = True):
    """(..., K) operand of a batch with leading dims `shape` -> (n, K)
    rows; a lone row stays (1, K) where the core reads it with stride 0
    (`lone_row_ok`) instead of being copied n times."""
    k = x.shape[-1]
    if lone_row_ok and x.size == k:
        return x.reshape(1, k)
    return jnp.broadcast_to(x, shape + (k,)).reshape(-1, k)


def _pmesh():
    from vmn_tpu.parallel import mesh  # imports this module

    return mesh


# ---------------------------------------------------------------- context


class MontCtx:
    """Montgomery context for a fixed odd modulus.

    Holds device-resident constants and exposes batched canonical-form
    operations.  Group elements are kept in Montgomery form by the group
    layer; field/ring elements in standard form (they are exponents).
    """

    def __init__(self, m: int):
        if m <= 0 or m % 2 == 0:
            raise ValueError("modulus must be positive and odd")
        self.m = m
        self.nbits = m.bit_length()
        self.L = num_limbs(self.nbits)
        self.R = 1 << (LIMB_BITS * self.L)
        self.R2 = self.R * self.R % m
        self.Rinv = pow(self.R, -1, m)
        self.mprime_int = (-pow(m, -1, 1 << LIMB_BITS)) & LIMB_MASK

        self.m_limbs = jnp.asarray(int_to_limbs(m, self.L))
        self.mprime = jnp.uint32(self.mprime_int)
        self.r2_limbs = jnp.asarray(int_to_limbs(self.R2, self.L))
        self.one_mont = jnp.asarray(int_to_limbs(self.R % m, self.L))
        self.one = jnp.asarray(int_to_limbs(1, self.L))
        self.zero = jnp.asarray(int_to_limbs(0, self.L))
        # Fixed-base tables are large device buffers (a window-8 table at
        # 2048 bits is ~33 MB of HBM).  Session-derived bases (h0 per mix
        # session) would accrete one table per session forever, so the
        # cache is a small LRU: long-lived bases (g, pk) are re-touched
        # every operation and stay resident; stale session tables fall
        # off the end and their HBM is freed.
        self._fb_tables = collections.OrderedDict()
        self._known_ints = collections.OrderedDict()

    # Sized for a k-party verification round: g, pk, per-party keys and
    # the session h0 can each hold a window-4 AND a window-8 entry, so a
    # small cap would thrash (rebuilds cost a full device table build).
    _FB_CACHE_MAX = 24
    _KNOWN_INT_MAX = 256

    # -------------------------------------------------------- conversions

    def to_mont(self, a):
        # through the dispatching mul, so batched conversions (every
        # serialization and sampling path) use the core on the GPU
        return self.mul(a, self.r2_limbs)

    def from_mont(self, a):
        return self.mul(a, self.one)

    def encode(self, xs) -> jnp.ndarray:
        """Python ints -> Montgomery-form device limbs (N, L)."""
        arr = jnp.asarray(ints_to_limbs(list(xs), self.L))
        return self.to_mont(arr)

    def encode_std(self, xs) -> jnp.ndarray:
        """Python ints -> standard-form device limbs (N, L)."""
        return jnp.asarray(ints_to_limbs(list(xs), self.L))

    def decode(self, a) -> list:
        """Montgomery-form limbs -> Python ints."""
        from vmn_tpu.arith.limbs import limbs_to_ints

        return limbs_to_ints(host_limbs(self.from_mont(a)))

    def decode_std(self, a) -> list:
        from vmn_tpu.arith.limbs import limbs_to_ints

        return limbs_to_ints(np.asarray(a))

    # --------------------------------------------------------- operations

    def _dispatch(self, batch, on_core, on_shards, on_xla):
        """Run one op over `batch`, a tuple of (n, ...) row operands.

        On the GPU (`_use_core`) the core runs it, single elements
        included (XLA's loop of one 2048-bit exponentiation costs
        seconds): `on_core(*batch)` on one device, or
        `on_shards(mesh, axis, *batch)` — the shard_map-wrapped core in
        `parallel.mesh`, with every operand broadcast to n rows — when
        the batch is sharded over a mesh (JAX shards an axis only when
        it divides).  Elsewhere, and for an empty batch, `on_xla()`."""
        n = max(x.shape[0] for x in batch)
        if n == 0 or not _use_core(self.L):
            return on_xla()
        info = shard_info(*batch)
        if info is None:
            return on_core(*batch)
        return on_shards(*info, *(
            jnp.broadcast_to(x, (n,) + x.shape[1:]) for x in batch))

    def mul(self, a, b):
        shape = jnp.broadcast_shapes(a.shape[:-1], b.shape[:-1])
        return self._dispatch(
            (_as_rows(a, shape), _as_rows(b, shape)),
            lambda a2, b2: core.mont_mul(a2, b2, self.m_limbs),
            lambda mesh, ax, a2, b2: _pmesh().sharded_mul(
                a2, b2, self.m_limbs, mesh, ax),
            lambda: mont_mul(a, b, self.m_limbs, self.mprime),
        ).reshape(shape + (self.L,))

    def add(self, a, b):
        return add_mod(a, b, self.m_limbs)

    def sub(self, a, b):
        return sub_mod(a, b, self.m_limbs)

    def neg(self, a):
        return sub_mod(jnp.broadcast_to(self.zero, a.shape), a, self.m_limbs)

    def exp(self, base, e, nbits: Optional[int] = None):
        nbits = self.nbits if nbits is None else nbits
        if base.ndim == 1 and e.ndim > 1:
            # shared base: the fixed-base path (no squarings) when the
            # base is host-known
            bi = self.known_int(base)
            if bi is not None:
                return self.exp_fixed(bi, e, nbits)
        shape = jnp.broadcast_shapes(base.shape[:-1], e.shape[:-1])
        return self._dispatch(
            (_as_rows(base, shape), _as_rows(e, shape, False)),
            lambda b2, e2: core.mont_exp(b2, e2, self.m_limbs,
                                         self.one_mont, nbits),
            lambda mesh, ax, b2, e2: _pmesh().sharded_exp(
                b2, e2, self.m_limbs, self.one_mont, nbits, mesh, ax),
            lambda: mont_exp(base, e, self.m_limbs, self.mprime,
                             self.one_mont, nbits),
        ).reshape(shape + (self.L,))

    def expprod(self, bases, e, nbits: Optional[int] = None):
        nbits = self.nbits if nbits is None else nbits
        if bases.ndim == 2 and e.ndim == 2 and bases.shape[0] >= 16:
            # Shared-squaring multi-exp: ~4-5x fewer products than
            # per-element exp + product tree.
            args = (self.m_limbs, self.mprime, self.one_mont, nbits)
            return self._dispatch(
                (bases, e),
                lambda b, e2: _expprod_fast(b, e2, *args),
                lambda mesh, ax, b, e2: _pmesh().sharded_exp_prod(
                    b, e2, *args, mesh, ax),
                lambda: _expprod_shared(bases, e, *args),
            )
        return self.prod(self.exp(bases, e, nbits), axis=0)

    def expprod_positions(self, bases, e, nbits: int):
        """(ceil(nbits / 4), L) per-digit-position products
        prod_i bases_i^{d_ij} of an (N, L) batch (see
        `_expprod_positions`)."""
        args = (self.m_limbs, self.mprime, self.one_mont, nbits)
        return self._dispatch(
            (bases, e),
            lambda b, e2: _positions_fast(b, e2, *args),
            lambda mesh, ax, b, e2: _pmesh().sharded_exp_prod_positions(
                b, e2, *args, mesh, ax),
            lambda: _expprod_positions(bases, e, *args),
        )

    def prod(self, x, axis=0):
        """Product over `axis` — one compiled tree program."""
        if axis != 0:
            x = jnp.moveaxis(x, axis, 0)
        args = (self.m_limbs, self.mprime, self.one_mont)
        tree = lambda y: _prod_tree(y, *args)  # noqa: E731
        if x.ndim != 2:
            return tree(x)
        return self._dispatch(
            (x,), tree,
            lambda mesh, ax, y: _pmesh().sharded_prod(y, *args, mesh, ax),
            lambda: tree(x),
        )

    def prods_scan(self, x):
        """Inclusive cumulative product over axis 0 (Montgomery form)."""
        args = (self.m_limbs, self.mprime, self.one_mont)
        if x.ndim != 2:
            return _prods_scan(x, *args)
        scan = (_prods_scan_chunked if x.shape[0] >= _SCAN_CHUNK_N
                else _prods_scan)
        return self._dispatch(
            (x,), lambda y: scan(y, *args),
            lambda mesh, ax, y: _pmesh().sharded_prods_scan(
                y, *args, mesh, ax),
            lambda: scan(x, *args),
        )

    def rec_lin(self, mult_mont, add_std):
        """x_i = x_{i-1}·e_i + b_i scan; returns standard-form (N, L)."""
        args = (self.m_limbs, self.mprime, self.one_mont)
        if mult_mont.ndim != 2:
            return _rec_lin_scan(mult_mont, add_std, *args)
        scan = (_rec_lin_chunked if mult_mont.shape[0] >= _SCAN_CHUNK_N
                else _rec_lin_scan)
        return self._dispatch(
            (mult_mont, add_std), lambda mm, aa: scan(mm, aa, *args),
            lambda mesh, ax, mm, aa: _pmesh().sharded_rec_lin(
                mm, aa, *args, mesh, ax),
            lambda: scan(mult_mont, add_std, *args),
        )

    def sum(self, x, axis=0):
        """Modular sum over `axis` — one compiled tree program."""
        if axis != 0:
            x = jnp.moveaxis(x, axis, 0)
        if x.ndim == 2:
            info = shard_info(x)
            if info is not None and x.shape[0] % info[0].size == 0:
                return _pmesh().sharded_sum(x, self.m_limbs, *info)
        return _sum_tree(x, self.m_limbs)

    def reduce_std(self, wide):
        """(…, Lw) canonical limbs of ANY magnitude -> value mod m.

        Splits x = hi·2^(16·L) + lo and uses hi·R mod m = to_mont(hi),
        lo mod m = to_mont(from_mont(lo)) — all batched device ops, no
        per-element Python.  Vectorizes uniform sampling x mod m of
        (nbits+statDist)-bit integers (reference: PRing/PGroup
        randomElementArray semantics).
        """
        L = self.L
        Lw = wide.shape[-1]
        nchunks = -(-Lw // L)
        if nchunks * L != Lw:
            pad = jnp.zeros(
                wide.shape[:-1] + (nchunks * L - Lw,), jnp.uint32
            )
            wide = jnp.concatenate([wide, pad], axis=-1)
        # Horner over L-limb chunks: acc = acc·R + chunk  (mod m);
        # acc·R mod m = to_mont(acc), chunk mod m = to_mont(from_mont(·)).
        acc = None
        for j in range(nchunks - 1, -1, -1):
            chunk = wide[..., j * L : (j + 1) * L]
            cm = self.to_mont(self.from_mont(chunk))
            acc = cm if acc is None else add_mod(
                self.to_mont(acc), cm, self.m_limbs
            )
        return acc

    def inv(self, a, order: Optional[int] = None):
        """Inverse via Fermat: a^(m-2) (m prime), or a^(order-1)."""
        e_int = (self.m - 2) if order is None else (order - 1)
        e = jnp.asarray(int_to_limbs(e_int, num_limbs(e_int.bit_length())))
        return self.exp(a, e, e_int.bit_length())

    # -------------------------------------------------------- fixed base

    def _fb_table_device(self, base_int: int, ndig: int, window: int):
        """(ndig, 2^window, L) Montgomery-form table, built on device.

        Host cost is only `ndig` Python modpows for the per-digit bases;
        the 2^window-entry columns come from one compiled scan of
        batched Montgomery products (see _fb_table_scan)."""
        from vmn_tpu.arith.limbs import ints_to_limbs

        m = self.m
        step = 1 << window
        bases = []
        bj = base_int % m
        for _ in range(ndig):
            bases.append(bj)
            bj = pow(bj, step, m)
        b_mont = self.to_mont(jnp.asarray(ints_to_limbs(bases, self.L)))
        return _fb_table_scan(
            b_mont, self.m_limbs, self.mprime, self.one_mont, step
        )

    def _fb_cache_get(self, key):
        tbl = self._fb_tables.get(key)
        if tbl is not None:
            self._fb_tables.move_to_end(key)
        return tbl

    def _fb_cache_put(self, key, tbl):
        self._fb_tables[key] = tbl
        while len(self._fb_tables) > self._FB_CACHE_MAX:
            self._fb_tables.popitem(last=False)

    def exp_fixed(self, base_int: int, e, nbits: Optional[int] = None):
        """base^e for a shared (host-known) integer base: a product of
        precomputed table rows, one per digit, and no squarings.  Window
        8 (half the products of window 4) for full-size exponents.
        `e`: (..., Le) standard limbs."""
        nbits = self.nbits if nbits is None else nbits
        window = 8 if nbits >= 512 else 4
        table = self.fixed_base_table(base_int, nbits, window)
        return self._dispatch(
            (e.reshape(-1, e.shape[-1]),),
            lambda e2: core.fb_exp(table, e2, self.m_limbs, self.one_mont),
            lambda mesh, ax, e2: _pmesh().sharded_fb_exp(
                table, e2, self.m_limbs, self.one_mont, mesh, ax),
            lambda: _fixed_base_exp(
                table, e, self.m_limbs, self.mprime, self.one_mont,
                table.shape[0], window,
            ),
        ).reshape(e.shape[:-1] + (self.L,))

    def known_int(self, limbs) -> Optional[int]:
        """Concrete Montgomery-form (L,) limbs -> int, cached by bytes.

        Returns None for traced values (inside jit).  Used to route
        shared-base exponentiations onto the fixed-base path.
        """
        if isinstance(limbs, jax.core.Tracer):
            return None
        raw = np.asarray(limbs)
        key = raw.tobytes()
        val = self._known_ints.get(key)
        if val is None:
            val = limbs_to_int(np.asarray(self.from_mont(limbs)))
            self._known_ints[key] = val
            while len(self._known_ints) > self._KNOWN_INT_MAX:
                self._known_ints.popitem(last=False)
        else:
            self._known_ints.move_to_end(key)
        return val

    def fixed_base_table(self, base_int: int, max_ebits: int, window: int = 8):
        """Build (or fetch cached) shared fixed-base table for `base_int`."""
        key = (base_int, max_ebits, window)
        tbl = self._fb_cache_get(key)
        if tbl is None:
            J = (max_ebits + window - 1) // window
            tbl = self._fb_table_device(base_int, J, window)
            self._fb_cache_put(key, tbl)
        return tbl

    def __repr__(self):
        return f"MontCtx(bits={self.nbits}, L={self.L})"
