"""Multi-process (multi-host proxy) SPMD tests.

Launches TWO separate Python processes, each owning 4 virtual CPU
devices, joined by `jax.distributed` into one 8-device runtime — the CI
proxy for a multi-host GPU deployment (reference analogue: the
ssh-distributed demo harness, demo/mixnet/macros:256-277).  A full
single-party mix runs as ONE SPMD program with the ciphertext axis
sharded across both processes; the test asserts both processes produce
byte-identical transcripts and that the transcript verifies standalone.
"""

import os
import socket
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.mark.skipif(os.environ.get("VMN_SKIP_SLOW") == "1",
                    reason="slow multi-process dryrun")
def test_two_process_spmd_mix(tmp_path):
    port = _free_port()
    n = 64
    procs = []
    for i in range(2):
        env = dict(os.environ)
        env.update(
            VMN_DIST_COORD=f"localhost:{port}",
            VMN_DIST_NPROC="2",
            VMN_DIST_PROCID=str(i),
            JAX_PLATFORMS="cpu",
            XLA_FLAGS="--xla_force_host_platform_device_count=4",
            # a cache of the test's own: both workers fill it together
            JAX_COMPILATION_CACHE_DIR=str(tmp_path / "jax_cache"),
        )
        procs.append(subprocess.Popen(
            [sys.executable, str(REPO / "tools" / "dist_worker.py"),
             str(tmp_path), str(n)],
            env=env, cwd=str(REPO),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        ))
    outs = []
    for p in procs:
        out, _ = p.communicate(timeout=900)
        outs.append(out.decode())
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-3000:]
    lines = [
        next(ln for ln in out.splitlines() if ln.startswith("DIST "))
        for out in outs
    ]
    digests = [ln.split("digest=")[1] for ln in lines]
    assert all("ok=True" in ln for ln in lines), lines
    assert digests[0] == digests[1], lines

    # the transcript verifies with the ordinary single-process verifier
    from vmn_tpu.arith.pgroup import ModPGroup
    from vmn_tpu.protocol.context import ProtocolParams
    from vmn_tpu.protocol.mixnet.verifier import FiatShamirVerifier

    group = ModPGroup.named("test256")
    params = ProtocolParams(sid="Dist", k=1, threshold=1, pgroup=group)
    res = FiatShamirVerifier(
        params, tmp_path / "proc0" / "nizkp.dist"
    ).verify(expected_type="mixing")
    assert res.ok
