"""vmn_tpu — a verifiable mix-net framework on JAX.

A from-scratch re-design of the capabilities of Verificatum VMN
(https://github.com/verificatum/verificatum-vmn) for accelerators:

- compute core (modular bigint arithmetic, group operations, proof batching)
  runs on the GPU via JAX/XLA with a CUDA Montgomery core for the hot loops;
- serialization, hashing and protocol orchestration run on the host;
- inter-party communication uses an authenticated bulletin board (HTTP),
  never device collectives — collectives are used only *within* one party's
  cards, where trust is uniform.

Layer map (mirrors reference SURVEY.md §1):
  arith/    — multi-limb Montgomery arithmetic + group/field/ring layer
              (reference: VCR com.verificatum.arithm, external to VMN repo)
  ops/      — the CUDA Montgomery core (products, exponentiation,
              fixed-base and multi-exponentiation)
              (reference: gmpmee/vec native C layer)
  eio/      — byte-tree canonical serialization
              (reference: VCR com.verificatum.eio)
  crypto/   — hash functions, PRG, random oracle, random sources
              (reference: VCR com.verificatum.crypto)
  protocol/ — El Gamal, zero-knowledge proofs (Terelius–Wikström),
              mix-net sessions, standalone verifier
              (reference: VMN com.verificatum.protocol.*)
  parallel/ — device-mesh sharding of the ciphertext axis
  cli/      — operator tools (vmn/vmni/vmnv/... equivalents)
"""

__version__ = "0.1.0"


def _enable_persistent_compile_cache():
    """Turn on JAX's persistent compilation cache for every entry point.

    The cache lives where JAX_COMPILATION_CACHE_DIR says, exactly; when
    that is unset, in `.jax_cache/` at the root of the checkout (listed in
    `.gitignore`).  The path is fixed because it is part of the cache key:
    a directory that moves never hits.  Only compiles of at least
    JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS (default 0) are kept.
    """
    import os

    cache_dir = os.environ.get("JAX_COMPILATION_CACHE_DIR") or os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        ".jax_cache",
    )
    try:
        os.makedirs(cache_dir, mode=0o700, exist_ok=True)
        if os.stat(cache_dir).st_uid != os.getuid():
            return  # refuse a directory owned by someone else
        import jax

        jax.config.update("jax_compilation_cache_dir", cache_dir)
        jax.config.update(
            "jax_persistent_cache_min_compile_time_secs",
            float(os.environ.get(
                "JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS", "0"
            )),
        )
        jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    except OSError:  # pragma: no cover - the cache is best-effort
        pass


_enable_persistent_compile_cache()

# Version string embedded in proofs.  The reference embeds the VCR version
# (reference: ProtocolElGamal.java:659-683 hashes VCR.version() into the
# global prefix; MixNetElGamalSession.java:102-103 writes it to `version`).
# Proofs produced by this framework are only byte-compatible with a
# reference installation of the same version.
VCR_COMPAT_VERSION = "3.1.0"
