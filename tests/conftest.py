"""Test configuration: run on a virtual 8-device CPU mesh.

Sharding correctness is validated on virtual CPU devices.  Tests marked
`gpu` need the card and skip elsewhere; run them on a GPU machine with
`JAX_PLATFORMS=cuda python -m pytest -m gpu tests/ -n 0`.
"""

import os

# Default to the CPU backend before any backend initializes; a run that
# names its platform (the `gpu` tests on the card) keeps it.
os.environ["JAX_PLATFORMS"] = os.environ.get("JAX_PLATFORMS") or "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])

os.environ.setdefault("JAX_PERSISTENT_CACHE_MIN_ENTRY_SIZE_BYTES", "-1")
# Persist only compiles worth >=2 s: the XLA:CPU AOT serializer in this
# jaxlib build segfaults intermittently (upstream bug — observed in
# executable.serialize() during cache writes and in the deserializer
# during reads, all under the compile lock below).  Caching only the
# expensive programs keeps warm suite runs fast while cutting the
# number of (de)serialize calls ~10x.
os.environ.setdefault("JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS", "2")

import pytest  # noqa: E402

# Serialize XLA:CPU compilation + persistent-cache writes across
# threads: multi-party tests compile from k threads at once, and the
# XLA:CPU AOT executable (de)serializer in this jaxlib build segfaults
# intermittently under concurrent compile/serialize (observed twice in
# full-suite runs, both inside compile_or_get_cached on worker
# threads).  A process-wide lock costs a little parallel-compile time
# and removes the crash window.
import threading as _threading  # noqa: E402

_compile_lock = _threading.RLock()


def _protocol_threads_live() -> bool:
    """True when worker threads (multi-party protocol tests) are live.

    Daemon threads (board hint loops) and ThreadPoolExecutor workers
    (the verifier's membership pool) don't count — they only wait or
    run host-side native code.
    """
    cur = _threading.current_thread()
    if cur is not _threading.main_thread():
        return True
    for t in _threading.enumerate():
        if t is cur or t.daemon:
            continue
        if t.name.startswith(("ThreadPoolExecutor", "MainThread")):
            continue
        return True
    return False


def _install_compile_lock():
    from jax._src import compilation_cache as _jcc
    from jax._src import compiler as _jcompiler

    # Segfaults were observed in the XLA:CPU AOT serializer AND
    # deserializer, exclusively while multi-party protocol tests had
    # other threads executing XLA programs (a compile lock alone did
    # not stop them, so the (de)serializer appears unsafe against
    # concurrent *execution*, not just compilation).  While protocol
    # worker threads are live, bypass persistent-cache reads and
    # writes entirely; the in-process pjit cache still dedupes.
    # (jax.config.update is NOT enough: is_cache_used() memoizes.)
    orig_get = _jcc.get_executable_and_time
    orig_put = _jcc.put_executable_and_time

    def gated_get(*a, **kw):
        if _protocol_threads_live():
            return None, None
        return orig_get(*a, **kw)

    def gated_put(*a, **kw):
        if _protocol_threads_live():
            return None
        return orig_put(*a, **kw)

    _jcc.get_executable_and_time = gated_get
    _jcc.put_executable_and_time = gated_put

    orig = _jcompiler.compile_or_get_cached

    def locked(*a, **kw):
        with _compile_lock:
            return orig(*a, **kw)

    _jcompiler.compile_or_get_cached = locked


_install_compile_lock()


@pytest.fixture(scope="session")
def small_group():
    """A small (256-bit) safe-prime group for fast protocol tests."""
    from vmn_tpu.arith.pgroup import ModPGroup

    return ModPGroup.named("test256")


@pytest.fixture(scope="session")
def modp2048():
    from vmn_tpu.arith.pgroup import ModPGroup

    return ModPGroup.named("modp2048")


@pytest.fixture(autouse=True)
def _gpu_only(request):
    """Skip `gpu`-marked tests when JAX has no GPU (decided per test)."""
    if request.node.get_closest_marker("gpu") is not None:
        if jax.default_backend() != "gpu":
            pytest.skip("needs a GPU (run with JAX_PLATFORMS=cuda on a card)")


def _clear_dispatch_caches():
    from vmn_tpu.parallel import mesh as pmesh

    jax.clear_caches()
    for name in dir(pmesh):
        fn = getattr(pmesh, name)
        if hasattr(fn, "cache_clear"):
            fn.cache_clear()


@pytest.fixture
def core_on_cpu(monkeypatch):
    """Route MontCtx through the Montgomery core's host build (its CPU
    FFI target), as the GPU routes through the CUDA build.  Jitted
    programs traced with the XLA route are dropped before and after."""
    from vmn_tpu.arith import mont
    from vmn_tpu.ops import core

    core.load("cpu")
    _clear_dispatch_caches()
    monkeypatch.setattr(mont, "_use_core", core.supports)
    yield core
    monkeypatch.undo()
    _clear_dispatch_caches()
