"""Mesh placement + shard-mapped core ops for the ciphertext axis.

The mix-net's scaling axis is N, the number of ciphertexts (reference
analogue: VCR thread-split array ops + file-mapped arrays, SURVEY.md
§2.5).  Every (N, L) limb tensor is placed with the N axis sharded over a
1-D `jax.sharding.Mesh`.  Two execution paths:

  * portable XLA path — GSPMD partitions the jitted limb ops directly
    (elementwise ops shard trivially, log-depth trees lower to
    per-shard reductions + collectives, `permute` becomes an all-to-all
    gather).  This is what CPU runs use.
  * CUDA core path — the Montgomery core (`vmn_tpu.ops.core`) is an FFI
    call, which GSPMD cannot partition, so sharded inputs route through
    the `shard_map`-wrapped ops in this module: each shard runs the core
    on its local (N/s, L) block and reductions/scans combine the tiny
    per-shard partials with mesh collectives (`all_gather`).  `MontCtx`
    dispatches here whenever an operand's batch axis is sharded over more
    than one device (see `mont.MontCtx._dispatch`).

The cards of one host are joined all to all, so the mesh is 1-D.  The
protocol layer is agnostic: `GArray`/`FArray`/`PPArray` wrap limb
tensors wherever they are placed, so sharding the *inputs* of a session
shards the whole mix.
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from vmn_tpu.arith import mont
from vmn_tpu.ops import core

CIPH_AXIS = "ciph"


def ciph_mesh(n_devices: Optional[int] = None) -> Mesh:
    """1-D mesh over the ciphertext batch axis."""
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.asarray(devs), (CIPH_AXIS,))


# Backwards-compatible alias (the former parallel/shard.py API).
make_mesh = ciph_mesh


def shard_limbs(limbs, mesh: Mesh, axis: str = CIPH_AXIS):
    """Place an (N, ..., L) limb tensor with the N axis sharded."""
    spec = P(axis, *([None] * (limbs.ndim - 1)))
    return jax.device_put(limbs, NamedSharding(mesh, spec))


shard_garray = shard_limbs


def shard_array(arr, mesh: Mesh):
    """Shard a GArray/FArray/PPArray/PPFArray over the mesh (N axis)."""
    from vmn_tpu.arith.pgroup import FArray, GArray, PPArray, PPFArray

    if isinstance(arr, (PPArray, PPFArray)):
        return type(arr)(
            arr.parent, tuple(shard_array(c, mesh) for c in arr.components)
        )
    if isinstance(arr, GArray):
        return GArray(arr.grp, shard_limbs(arr.limbs, mesh))
    if isinstance(arr, FArray):
        return FArray(arr.field, shard_limbs(arr.limbs, mesh))
    raise TypeError(f"cannot shard {type(arr)!r}")


def replicate(x, mesh: Mesh):
    return jax.device_put(x, NamedSharding(mesh, P()))


# =====================================================================
# shard_map-wrapped Montgomery ops (the multi-card core path)
# =====================================================================
#
# Every op below runs the core on each shard's local block and combines
# per-shard partials with mesh collectives.  Montgomery arithmetic is
# exact mod m, so any reduction/scan tree shape yields bit-identical
# canonical limbs — sharded results match the single-device run exactly.
#
# The factories are lru_cached per (mesh, axis, ...) so each jitted
# shard_map program is built once.


@functools.lru_cache(maxsize=None)
def _mul_fn(mesh: Mesh, axis: str):
    return jax.jit(shard_map(
        core.mont_mul, mesh=mesh,
        in_specs=(P(axis, None), P(axis, None), P(None)),
        out_specs=P(axis, None), check_vma=False,
    ))


def sharded_mul(a, b, m, mesh, axis):
    """(N, L) x (N, L) Montgomery product, N sharded over the mesh."""
    return _mul_fn(mesh, axis)(a, b, m)


@functools.lru_cache(maxsize=None)
def _exp_fn(mesh: Mesh, axis: str, nbits: int):
    def local(b, e, m, one):
        return core.mont_exp(b, e, m, one, nbits)

    return jax.jit(shard_map(
        local, mesh=mesh,
        in_specs=(P(axis, None), P(axis, None), P(None), P(None)),
        out_specs=P(axis, None), check_vma=False,
    ))


def sharded_exp(b, e, m, one, nbits, mesh, axis):
    """b^e elementwise, batch sharded over the mesh."""
    return _exp_fn(mesh, axis, nbits)(b, e, m, one)


@functools.lru_cache(maxsize=None)
def _fb_fn(mesh: Mesh, axis: str):
    return jax.jit(shard_map(
        core.fb_exp, mesh=mesh,
        in_specs=(P(None, None, None), P(axis, None), P(None), P(None)),
        out_specs=P(axis, None), check_vma=False,
    ))


def sharded_fb_exp(table, e, m, one, mesh, axis):
    """Fixed-base exponentiation: replicated table, sharded exponents."""
    return _fb_fn(mesh, axis)(table, e, m, one)


@functools.lru_cache(maxsize=None)
def _prod_fn(mesh: Mesh, axis: str):
    def local(x, m, mp, one):
        part = mont._prod_tree(x, m, mp, one)  # (L,)
        parts = jax.lax.all_gather(part, axis)  # (s, L)
        return mont._prod_tree(parts, m, mp, one)[None]

    return jax.jit(shard_map(
        local, mesh=mesh,
        in_specs=(P(axis, None), P(None), P(), P(None)),
        out_specs=P(axis, None), check_vma=False,
    ))


def sharded_prod(x, m, mp, one, mesh, axis):
    """Product over the sharded axis 0 -> (L,) (replicated result)."""
    return _prod_fn(mesh, axis)(x, m, mp, one)[0]


@functools.lru_cache(maxsize=None)
def _sum_fn(mesh: Mesh, axis: str):
    def local(x, m):
        part = mont._sum_tree(x, m)
        parts = jax.lax.all_gather(part, axis)
        return mont._sum_tree(parts, m)[None]

    return jax.jit(shard_map(
        local, mesh=mesh,
        in_specs=(P(axis, None), P(None)),
        out_specs=P(axis, None), check_vma=False,
    ))


def sharded_sum(x, m, mesh, axis):
    """Modular sum over the sharded axis 0 -> (L,)."""
    return _sum_fn(mesh, axis)(x, m)[0]


@functools.lru_cache(maxsize=None)
def _expprod_fn(mesh: Mesh, axis: str, nbits: int):
    def local(bases, e, m, mp, one):
        part = mont._expprod_fast(bases, e, m, mp, one, nbits)
        parts = jax.lax.all_gather(part, axis)  # (s, L)
        return mont._prod_tree(parts, m, mp, one)[None]

    return jax.jit(shard_map(
        local, mesh=mesh,
        in_specs=(P(axis, None), P(axis, None), P(None), P(), P(None)),
        out_specs=P(axis, None), check_vma=False,
    ))


def sharded_exp_prod(bases, e, m, mp, one, nbits, mesh, axis=CIPH_AXIS):
    """prod_i b_i^{e_i} with the N axis sharded across the mesh.

    Per-shard shared-squaring multi-exp + an `all_gather` of one (L,)
    partial per shard + a tiny final combine — the gmpmee-spowm
    analogue across cards (reference: SURVEY.md §2.3, §2.5 "batch data
    parallelism").
    """
    return _expprod_fn(mesh, axis, nbits)(bases, e, m, mp, one)[0]


@functools.lru_cache(maxsize=None)
def _positions_fn(mesh: Mesh, axis: str, nbits: int):
    def local(bases, e, m, mp, one):
        part = mont._positions_fast(bases, e, m, mp, one, nbits)
        parts = jax.lax.all_gather(part, axis)  # (s, ndig, L)
        acc = parts[0]
        for j in range(1, parts.shape[0]):
            acc = mont._mul_dispatch(acc, parts[j], m, mp)
        return acc[None]

    return jax.jit(shard_map(
        local, mesh=mesh,
        in_specs=(P(axis, None), P(axis, None), P(None), P(), P(None)),
        out_specs=P(axis, None, None), check_vma=False,
    ))


def sharded_exp_prod_positions(bases, e, m, mp, one, nbits, mesh, axis):
    """Per-digit-position products (`mont._expprod_positions`) with the
    N axis sharded: per-shard positions, multiplied across shards."""
    return _positions_fn(mesh, axis, nbits)(bases, e, m, mp, one)[0]


@functools.lru_cache(maxsize=None)
def _prods_fn(mesh: Mesh, axis: str):
    def local(x, m, mp, one):
        y = mont._prods_scan(x, m, mp, one)  # local inclusive
        totals = jax.lax.all_gather(y[-1], axis)  # (s, L)
        # exclusive prefix of the shard totals for THIS shard
        idx = jax.lax.axis_index(axis)
        s = totals.shape[0]
        keep = (jnp.arange(s) < idx)[:, None]
        masked = jnp.where(keep, totals, jnp.broadcast_to(one, totals.shape))
        pre = mont._prod_tree(masked, m, mp, one)  # (L,)
        return mont._mont_mul(y, pre[None, :], m, mp)

    return jax.jit(shard_map(
        local, mesh=mesh,
        in_specs=(P(axis, None), P(None), P(), P(None)),
        out_specs=P(axis, None), check_vma=False,
    ))


def sharded_prods_scan(x, m, mp, one, mesh, axis):
    """Inclusive cumulative Montgomery product, sharded axis 0."""
    return _prods_fn(mesh, axis)(x, m, mp, one)


@functools.lru_cache(maxsize=None)
def _rec_lin_fn(mesh: Mesh, axis: str):
    def local(mm, aa, m, mp, one):
        # Per-shard affine scan with x_in = 0, then compose the incoming
        # state from the previous shards' (M_total, A_last) pairs:
        #   x_i = A_loc_i + x_in * M_pref_i
        a_loc = mont._rec_lin_scan(mm, aa, m, mp, one)
        m_pref = mont._prods_scan(mm, m, mp, one)
        pairs_m = jax.lax.all_gather(m_pref[-1], axis)  # (s, L) mont
        pairs_a = jax.lax.all_gather(a_loc[-1], axis)  # (s, L) std
        idx = jax.lax.axis_index(axis)
        s = pairs_m.shape[0]
        zero = jnp.zeros_like(pairs_a[0])

        def step(j, x):
            nxt = mont.add_mod(
                mont._mont_mul(pairs_m[j], x, m, mp), pairs_a[j], m
            )
            return jnp.where(j < idx, nxt, x)

        x_in = jax.lax.fori_loop(0, s, step, zero)  # std form
        return mont.add_mod(
            mont._mont_mul(m_pref, x_in[None, :], m, mp), a_loc, m
        )

    return jax.jit(shard_map(
        local, mesh=mesh,
        in_specs=(P(axis, None), P(axis, None), P(None), P(), P(None)),
        out_specs=P(axis, None), check_vma=False,
    ))


def sharded_rec_lin(mm, aa, m, mp, one, mesh, axis):
    """Affine recurrence x_i = x_{i-1}*e_i + b_i, sharded axis 0."""
    return _rec_lin_fn(mesh, axis)(mm, aa, m, mp, one)
