"""The CUDA Montgomery core for the hot arithmetic ops.

This package replaces the reference's native C layer (reference:
SURVEY.md §2.3 — GMP/gmpmee modular and simultaneous/fixed-base
exponentiation).  `vmn_tpu.arith.mont` is the portable XLA path and
chooses the core on the GPU (`core.py`); `parity.py` checks the two
against each other and against Python `pow`.
"""
