"""Bit-exact parity checks of the Montgomery core at a real width.

`check_core` runs each entry point of `vmn_tpu.ops.core` on one batch and
compares its limbs with Python `pow` (sampled rows; every row for the
product and the multi-exponentiation) and with the plain XLA path in
`vmn_tpu.arith.mont` (a leading slice of the batch).  The arithmetic is
exact, so the tolerance is zero.  `chip_smoke.py` and the GPU-marked test
in `tests/test_scale.py` both call it.
"""

from __future__ import annotations

import time

import jax
import jax.numpy as jnp
import numpy as np

from vmn_tpu.arith import mont
from vmn_tpu.arith.limbs import ints_to_limbs, limbs_to_ints
from vmn_tpu.ops import core


def _timed(fn, *args):
    jax.block_until_ready(fn(*args))  # compile + warm
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    return out, time.perf_counter() - t0


def _random_below(rng, m: int, n: int, L: int) -> np.ndarray:
    """(n, L) limbs of values uniform-ish below m (top limb reduced)."""
    x = rng.integers(0, 1 << 16, size=(n, L), dtype=np.uint32)
    top = int(m >> (16 * (L - 1)))
    x[:, L - 1] %= top
    return x


def check_core(group, n: int, seed: int = 0, pow_rows: int = 48,
               xla_rows: int = 256, log=print) -> dict:
    """Raise AssertionError on any mismatch; return timings (seconds)."""
    ctx = group.ctx
    m, L, R = ctx.m, ctx.L, ctx.R
    Rinv = pow(R, -1, m)
    nbits = m.bit_length()
    rng = np.random.default_rng(seed)
    times = {}

    def to_dev(ints):
        return jnp.asarray(ints_to_limbs(ints, L))

    # Operands in Montgomery form; edge values in the first and last rows.
    a_np = _random_below(rng, m, n, L)
    b_np = _random_below(rng, m, n, L)
    edges = [0, 1, R % m, m - 1, m - 2]
    a_np[: len(edges)] = ints_to_limbs(edges, L)
    a_np[-len(edges):] = ints_to_limbs(edges[::-1], L)
    b_np[: len(edges)] = ints_to_limbs(edges[::-1], L)
    e_np = rng.integers(0, 1 << 16, size=(n, L), dtype=np.uint32)
    full = nbits // 16
    if nbits % 16:
        e_np[:, full] &= (1 << (nbits % 16)) - 1
        full += 1
    e_np[:, full:] = 0
    e_edges = [0, 1, m - 1, (1 << nbits) - 1]
    e_np[: len(e_edges)] = ints_to_limbs(e_edges, L)
    e_np[-len(e_edges):] = ints_to_limbs(e_edges, L)
    a, b, e = jnp.asarray(a_np), jnp.asarray(b_np), jnp.asarray(e_np)
    a_int, b_int = limbs_to_ints(a_np), limbs_to_ints(b_np)
    e_int = limbs_to_ints(e_np)
    rows = sorted(set(
        list(range(8)) + list(range(n - 8, n))
        + [int(i) for i in rng.integers(0, n, size=max(0, pow_rows - 16))]
    ))
    mm, mp, one = ctx.m_limbs, ctx.mprime, ctx.one_mont

    # -- product: every row against Python, every row against XLA
    got, times["core_mul"] = _timed(core.mont_mul, a, b, mm)
    xla, times["xla_mul"] = _timed(mont.mont_mul, a, b, mm, mp)
    got_np = np.asarray(got)
    assert np.array_equal(got_np, np.asarray(xla)), "mul: core != XLA"
    want = [x * y * Rinv % m for x, y in zip(a_int, b_int)]
    assert limbs_to_ints(got_np) == want, "mul: core != pow"
    log(f"  mont_mul   N={n}: bit-identical to Python and XLA "
        f"(core {times['core_mul']:.4f} s, XLA {times['xla_mul']:.4f} s)")

    # -- variable-base exponentiation
    got, times["core_exp"] = _timed(
        lambda x, y: core.mont_exp(x, y, mm, one, nbits), a, e)
    got_np = np.asarray(got)
    for i in rows:
        x = a_int[i] * Rinv % m
        w = pow(x, e_int[i], m) * R % m
        assert limbs_to_ints(got_np[i:i + 1])[0] == w, f"exp: row {i}"
    k = min(n, xla_rows)
    xla, times["xla_exp"] = _timed(
        lambda x, y: mont.mont_exp(x, y, mm, mp, one, nbits), a[:k], e[:k])
    assert np.array_equal(got_np[:k], np.asarray(xla)), "exp: core != XLA"
    log(f"  mont_exp   N={n}: {len(rows)} rows = pow, {k} rows = XLA "
        f"(core {times['core_exp']:.4f} s for {n}; XLA "
        f"{times['xla_exp']:.4f} s for {k})")

    # -- fixed base, window 8 (the full-size table) and window 4
    g = group.g_int if hasattr(group, "g_int") else 5
    for window in (8, 4):
        table = ctx.fixed_base_table(g, nbits, window)
        got, t = _timed(lambda y: core.fb_exp(table, y, mm, one), e)
        times[f"core_fb{window}"] = t
        got_np = np.asarray(got)
        for i in rows:
            w = pow(g, e_int[i], m) * R % m
            assert limbs_to_ints(got_np[i:i + 1])[0] == w, \
                f"fb{window}: row {i}"
        xla, t = _timed(
            lambda y: mont._fixed_base_exp(table, y, mm, mp, one,
                                           table.shape[0], window), e[:k])
        times[f"xla_fb{window}"] = t
        assert np.array_equal(got_np[:k], np.asarray(xla)), \
            f"fb{window}: core != XLA"
        log(f"  fb_exp w={window} N={n}: table {table.nbytes / 1e6:.1f} MB, "
            f"{len(rows)} rows = pow, {k} rows = XLA "
            f"(core {times[f'core_fb{window}']:.4f} s)")

    # -- multi-exponentiation: bases g^(i+1), so the reference is one pow
    gi, cur = [], 1
    for _ in range(n):
        cur = cur * g % m
        gi.append(cur * R % m)
    bases = to_dev(gi)
    got, times["core_expprod"] = _timed(
        lambda x, y: core.expprod(x, y, mm, one, nbits), bases, e)
    q = getattr(group, "q", None)
    s = sum((i + 1) * x for i, x in enumerate(e_int))
    if q is not None:
        s %= q
    want = pow(g, s, m) * R % m
    assert limbs_to_ints(np.asarray(got)[None])[0] == want, "expprod != pow"
    k = min(k, 64)
    xla = mont._expprod_shared(bases[:k], e[:k], mm, mp, one, nbits)
    got_k = core.expprod(bases[:k], e[:k], mm, one, nbits)
    assert np.array_equal(np.asarray(got_k), np.asarray(xla)), \
        "expprod: core != XLA"
    log(f"  expprod    N={n}: = pow (one-pow reference), {k} rows = XLA "
        f"(core {times['core_expprod']:.4f} s)")
    return times
