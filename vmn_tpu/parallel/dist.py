"""Multi-host (multi-process) runtime startup and global-array helpers.

The reference scales across machines by running one JVM per mix-server
plus VCR's transparent array-op parallelism inside each
(reference: demo/mixnet/macros:256-277 ssh distribution; SURVEY.md §2.5
multi-host rows).  Design: ONE party's device work spans several hosts as
a single SPMD program — every process runs the same protocol code, arrays
are `jax.Array`s sharded over the GLOBAL mesh, and XLA inserts the
collectives.

One process per host drives all of that host's cards.  Several processes
on one multi-card host must each be given their own card
(`CUDA_VISIBLE_DEVICES=<i>`): a JAX process reserves most of every
card it sees when it first uses it, so without that they would all
reserve card 0.

Launch contract (env-driven, also settable via `vmn -dist`):

    VMN_DIST_COORD=host:port   coordinator address (process 0's host)
    VMN_DIST_NPROC=<n>         number of processes
    VMN_DIST_PROCID=<i>        this process's id in [0, n)

`init_from_env()` is called by the CLI entry points and `bench.py`
before first device use.  After it, `jax.devices()` is the global
device list and `parallel.mesh.ciph_mesh()` spans all hosts.

CPU dryrun proxy (no GPUs needed): two localhost processes with
`--xla_force_host_platform_device_count` devices each — exercised by
`tests/test_dist.py` via `tools/dist_worker.py`, asserting transcripts
are produced through real cross-process collectives and verify with the
standalone verifier.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

_initialized = False


def init_from_env() -> bool:
    """Initialize `jax.distributed` when the VMN_DIST_* env triplet is
    present.  Returns True when running multi-process.  Idempotent."""
    global _initialized
    coord = os.environ.get("VMN_DIST_COORD")
    if not coord:
        return False
    if _initialized:
        return True
    nproc = int(os.environ["VMN_DIST_NPROC"])
    procid = int(os.environ["VMN_DIST_PROCID"])
    import jax

    jax.distributed.initialize(
        coordinator_address=coord,
        num_processes=nproc,
        process_id=procid,
    )
    _initialized = True
    return True


def is_multiprocess() -> bool:
    import jax

    return jax.process_count() > 1


def process_index() -> int:
    import jax

    return jax.process_index()


def make_global(full_np, mesh, spec) -> "jax.Array":
    """Build a GLOBAL sharded array from host data every process holds.

    Each process materializes only its addressable shards — the
    standard multi-host ingestion path (`jax.make_array_from_callback`).
    `full_np` must be identical across processes (in the mix-net it is:
    all inputs come from the shared transcript/board bytes or from the
    session's deterministic seed).
    """
    import jax
    from jax.sharding import NamedSharding

    full_np = np.asarray(full_np)
    sharding = NamedSharding(mesh, spec)
    return jax.make_array_from_callback(
        full_np.shape, sharding, lambda idx: full_np[idx]
    )


def shard_array_global(arr, mesh):
    """Multi-process version of `parallel.mesh.shard_array`: shard a
    GArray/FArray/PPArray over the global mesh from replicated host
    limbs."""
    from jax.sharding import PartitionSpec as P

    from vmn_tpu.arith.pgroup import FArray, GArray, PPArray, PPFArray
    from vmn_tpu.parallel.mesh import CIPH_AXIS

    if isinstance(arr, (PPArray, PPFArray)):
        return type(arr)(
            arr.parent,
            tuple(shard_array_global(c, mesh) for c in arr.components),
        )
    spec = P(CIPH_AXIS, *([None] * (arr.limbs.ndim - 1)))
    limbs = make_global(np.asarray(arr.limbs), mesh, spec)
    if isinstance(arr, GArray):
        return GArray(arr.grp, limbs)
    if isinstance(arr, FArray):
        return FArray(arr.field, limbs)
    raise TypeError(f"cannot shard {type(arr)!r}")


def gather_to_host(x) -> np.ndarray:
    """Fetch a possibly non-fully-addressable global array to the host
    (every process gets the full value)."""
    import jax

    if isinstance(x, jax.Array) and not x.is_fully_addressable:
        from jax.experimental import multihost_utils

        return np.asarray(multihost_utils.process_allgather(x, tiled=True))
    return np.asarray(x)
