"""The Montgomery core: CUDA kernels called through `jax.ffi`.

One device function, the CIOS Montgomery product over packed 32-bit words
(`mont_core.h`), serves four batched entry points:

  * `mont_mul`   — elementwise product (either operand may be one row);
  * `mont_exp`   — fixed 4-bit-window exponentiation, one thread per element;
  * `fb_exp`     — fixed-base exponentiation over a shared window table
                   (4- or 8-bit digits), one row read per digit;
  * `expprod`    — multi-exponentiation prod_i b_i^{e_i} by digit positions
                   (Yao), or the per-position products themselves.

Arrays keep the repository's (N, L) layout of 16-bit limbs in uint32, in
Montgomery form for R = 2^(16 L); the kernels pack limb pairs into words.
The library is built from the committed sources into `_build/` (listed in
`.gitignore`) on first use: `nvcc` for the GPU, `g++` for a host build of
the same arithmetic that only the tests call.  A failed build raises —
there is no silent fallback.  Build it ahead of time with
`python -m vmn_tpu.ops.core`.
"""

from __future__ import annotations

import ctypes
import fcntl
import functools
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np

# 32-bit word counts the library is instantiated for (mont_core.h
# VMN_FOR_EACH_WIDTH): P-224, 256-bit, P-384, P-521, 2048, 3072, 4096 bits.
WIDTHS = (7, 8, 12, 17, 64, 96, 128)

_DIR = Path(__file__).parent
_BUILD = _DIR / "_build"
_HEADER = _DIR / "mont_core.h"
_SRC = {"gpu": _DIR / "mont_gpu.cu", "cpu": _DIR / "mont_cpu.cc"}
_FFI_PLATFORM = {"gpu": "CUDA", "cpu": "cpu"}
_TARGETS = (
    ("vmn_mont_mul", "VmnMontMul"),
    ("vmn_mont_exp", "VmnMontExp"),
    ("vmn_mont_fb_exp", "VmnMontFbExp"),
    ("vmn_mont_expprod", "VmnMontExpProd"),
)

# Threads the position kernel should have in flight: digit positions x
# element chunks (enough to fill the card's SMs several times over).
_POSITION_THREADS = 1 << 16

_lock = threading.Lock()
_loaded: dict = {}


def supports(L: int) -> bool:
    """True when the library has a build for L 16-bit limbs."""
    return (L + 1) // 2 in WIDTHS


def _compile_cmd(platform: str, out: Path) -> list:
    inc = jax.ffi.include_dir()
    src = str(_SRC[platform])
    if platform == "gpu":
        nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
        return [nvcc, "-gencode", "arch=compute_90a,code=sm_90a",
                "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
                "-I", inc, "-o", str(out), src]
    return ["g++", "-std=c++17", "-O2", "-shared", "-fPIC", "-I", inc,
            "-o", str(out), src]


def build(platform: str) -> Path:
    """Compile the library for `platform` ("gpu" or "cpu") unless an
    up-to-date build exists; returns its path.  Safe across processes."""
    _BUILD.mkdir(exist_ok=True)
    so = _BUILD / f"libvmn_mont_{platform}.so"
    newest = max(_HEADER.stat().st_mtime, _SRC[platform].stat().st_mtime)
    with open(_BUILD / f".{platform}.lock", "w") as lk:
        fcntl.flock(lk, fcntl.LOCK_EX)
        if so.exists() and so.stat().st_mtime >= newest:
            return so
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.run(_compile_cmd(platform, tmp),
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"building the Montgomery core for {platform} failed:\n"
                + proc.stderr[-4000:]
            )
        os.replace(tmp, so)
    return so


def load(platform: str) -> float:
    """Build (if needed) and register the FFI targets for `platform`.
    Returns the seconds it took (zero once loaded)."""
    with _lock:
        if platform in _loaded:
            return 0.0
        t0 = time.perf_counter()
        lib = ctypes.cdll.LoadLibrary(str(build(platform)))
        for name, sym in _TARGETS:
            jax.ffi.register_ffi_target(
                name, jax.ffi.pycapsule(getattr(lib, sym)),
                platform=_FFI_PLATFORM[platform],
            )
        _loaded[platform] = lib  # keeps the library mapped
        return time.perf_counter() - t0


def _call(name, out_shapes, *args, **attrs):
    platform = jax.default_backend()
    if platform not in _FFI_PLATFORM:
        raise RuntimeError(f"no Montgomery core for platform {platform!r}")
    load(platform)
    return jax.ffi.ffi_call(name, out_shapes)(*args, **attrs)


def _u32(shape):
    return jax.ShapeDtypeStruct(shape, jnp.uint32)


def _rows(*arrays) -> int:
    n = max(x.shape[0] for x in arrays)
    for x in arrays:
        if x.shape[0] not in (1, n):
            raise ValueError(f"batch sizes {[a.shape for a in arrays]}")
    return n


@jax.jit
def mont_mul(a, b, m):
    """(N, L) x (N, L) -> (N, L) Montgomery product; either operand may
    be a single (1, L) row."""
    n = _rows(a, b)
    return _call("vmn_mont_mul", _u32((n, m.shape[0])), a, b, m)


@functools.partial(jax.jit, static_argnames=("nbits",))
def mont_exp(base, e, m, one, nbits: int):
    """base^e in Montgomery form: base (N, L) or (1, L), e (N, Le)
    standard-form limbs below 2^nbits."""
    n = _rows(base, e)
    ndig = -(-nbits // 4)
    return _call("vmn_mont_exp", _u32((n, m.shape[0])), base, e, m, one,
                 ndig=np.int64(ndig))


@jax.jit
def fb_exp(table, e, m, one):
    """prod_j table[j][digit_j(e)] for a shared (J, 2^w, L) table,
    w in {4, 8}, and (N, Le) exponents."""
    return _call("vmn_mont_fb_exp", _u32((e.shape[0], m.shape[0])), table,
                 e, m, one)


def _expprod_call(bases, e, m, one, nbits: int, positions: bool):
    n, L = bases.shape
    W = (L + 1) // 2
    ndig = max(1, -(-nbits // 4))
    nchunks = max(1, min(n, -(-_POSITION_THREADS // ndig)))
    out, _, _ = _call(
        "vmn_mont_expprod",
        (_u32((ndig if positions else 1, L)), _u32((n * 16 * W,)),
         _u32(((nchunks + 1) * ndig * W,))),
        bases, e, m, one,
        ndig=np.int64(ndig), nchunks=np.int64(nchunks),
        positions=np.int64(positions),
    )
    return out


@functools.partial(jax.jit, static_argnames=("nbits",))
def expprod(bases, e, m, one, nbits: int):
    """prod_i bases_i^{e_i} -> (L,) for (N, L) bases (N >= 1) and (N, Le)
    exponents below 2^nbits."""
    return _expprod_call(bases, e, m, one, nbits, False)[0]


@functools.partial(jax.jit, static_argnames=("nbits",))
def expprod_positions(bases, e, m, one, nbits: int):
    """Per-position products P_j = prod_i bases_i^{d_ij} for the 4-bit
    digits d_ij of e_i -> (ceil(nbits / 4), L)."""
    return _expprod_call(bases, e, m, one, nbits, True)


if __name__ == "__main__":
    plat = "gpu" if shutil.which("nvcc") or Path(
        "/usr/local/cuda/bin/nvcc").exists() else "cpu"
    t = time.perf_counter()
    print(build(plat), f"{time.perf_counter() - t:.1f} s")
