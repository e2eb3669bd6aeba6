"""Array storage backends: RAM vs disk-spilled (out-of-core).

The reference supports file-mapped `LargeIntegerArray`s so that N can
exceed host RAM (reference: ProtocolElGamal.java:332-345, the `arrays`
private-info field, toggled in the check matrix `ARRAYS=file`).

The device-batched equivalent (SURVEY.md §2.5): large *resident* arrays —
cached generators, permutation commitments, re-encryption factors,
ciphertext lists between rounds — are spilled to ``np.memmap`` files on
disk; device kernels stream slices from the memmap on demand, so host
RAM holds only the working chunk while HBM holds only what a kernel
touches.  Compute paths are unchanged: a memmap is a drop-in ndarray.
"""

from __future__ import annotations

import atexit
import os
import tempfile
from pathlib import Path
from typing import Optional

import numpy as np

_BACKEND = "ram"
_SPILL_DIR: Optional[Path] = None
_COUNTER = 0
# Arrays smaller than this stay in RAM even in file mode (spilling tiny
# arrays costs more in file churn than it saves).
MIN_SPILL_BYTES = 1 << 20


def set_backend(mode: str, directory=None) -> None:
    """Select the array backend: ``ram`` (default) or ``file``.

    ``directory`` is where spill files live (the party's working
    directory in protocol runs); a temp dir is used if omitted.
    """
    global _BACKEND, _SPILL_DIR
    if mode not in ("ram", "file"):
        raise ValueError(f"unknown array backend: {mode}")
    _BACKEND = mode
    if directory is not None:
        _SPILL_DIR = Path(directory)
        _SPILL_DIR.mkdir(parents=True, exist_ok=True)


def backend() -> str:
    return _BACKEND


def _spill_path() -> Path:
    global _SPILL_DIR, _COUNTER
    if _SPILL_DIR is None:
        d = tempfile.mkdtemp(prefix="vmn_arrays_")
        _SPILL_DIR = Path(d)
        atexit.register(_cleanup, d)
    _COUNTER += 1
    return _SPILL_DIR / f"spill{_COUNTER:06d}.npy"


def _cleanup(d: str) -> None:
    try:
        for f in Path(d).glob("spill*.npy"):
            f.unlink(missing_ok=True)
        os.rmdir(d)
    except OSError:
        pass


def maybe_spill(arr):
    """Move a host array to a disk-backed memmap when in file mode.

    Returns the input unchanged in ram mode, for device arrays that are
    cheap to keep, or for arrays under MIN_SPILL_BYTES.
    """
    if _BACKEND != "file":
        return arr
    a = np.asarray(arr)
    if a.nbytes < MIN_SPILL_BYTES:
        return a
    if isinstance(arr, np.memmap):
        return arr
    path = _spill_path()
    mm = np.lib.format.open_memmap(
        path, mode="w+", dtype=a.dtype, shape=a.shape
    )
    mm[...] = a
    mm.flush()
    # Reopen read-only so accidental writes cannot corrupt cached state.
    del mm
    return np.load(path, mmap_mode="r")
