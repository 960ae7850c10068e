"""Multi-host distribution: N processes x M virtual CPU devices.

The standard JAX multi-host recipe (``jax.distributed.initialize`` with a
shared coordinator; SURVEY.md §2.3, BASELINE.md): each spawned worker
contributes local devices to ONE global 8-device mesh and runs the same
SPMD program; collectives cross the process boundary (DCN-analog).
Process 0 checks the gathered output against the single-device path.

Round 5 (VERDICT r4 item 5): one test per collective path — a failure
names the collective it validates instead of reporting as one opaque
monolith error — plus a 4-process x 2-device run so more than one
process/device factorization of the same 8-device mesh is exercised.
On a real multi-host GPU cluster the identical worker runs unchanged
with the GPU backend.
"""

import os
import socket
import subprocess
import sys

import pytest

WORKER = os.path.join(os.path.dirname(__file__), "..", "benchmarks",
                      "multihost_worker.py")


def _free_port():
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _run_workers(nproc, local, consistent, path):
    env = dict(os.environ)
    # the workers force CPU themselves
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
    env.pop("XLA_FLAGS", None)  # workers set their own device count

    port = _free_port()
    procs = [
        subprocess.Popen(
            [sys.executable, WORKER, str(pid), str(nproc), str(port),
             str(local), consistent, path],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
        for pid in range(nproc)
    ]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=600)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, f"worker failed ({path}):\n{out}"
    assert f"MULTIHOST-OK path={path}" in outs[0], outs[0]
    assert f"processes={nproc}" in outs[0]
    return outs[0]


# One test per collective path (2 processes x 4 devices). Each validates
# a distinct cross-process collective:
#   asw — halo ppermute of the row-tiled matcher + a psum reduction
#   sgm — the wavefront pipeline's sequential scan-carry ppermute chain
#   gsw — halo ppermutes under shard_map with the GSW body
#   ftp — boundary-row ppermute + all_gather of the distributed y-unwrap
#         and the psum'd fringe order
#   ba  — psum'd Schur-complement normal equations
@pytest.mark.parametrize("path", ["asw", "sgm", "gsw", "ftp", "ba"])
def test_two_process_path(path):
    _run_workers(2, 4, "1", path)


def test_two_process_asw_inconsistent():
    """Non-consistent matching mode of the row-tiled kernel (the
    consistent flag changes the kernel's halo semantics)."""
    _run_workers(2, 4, "0", "asw")


def test_four_process_two_device_asw():
    """Same 8-device global mesh factorized as 4 processes x 2 local
    devices: more process boundaries inside the same ppermute ring."""
    _run_workers(4, 2, "1", "asw")


def test_four_process_two_device_ftp():
    """4x2 factorization of the FTP collectives (all_gather + psum with
    4-way process fan-in)."""
    _run_workers(4, 2, "1", "ftp")
