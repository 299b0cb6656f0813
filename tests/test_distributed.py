"""Multi-PROCESS SPMD level: the rung between the single-process CPU-mesh
tests and a multi-process GPU deployment.

Two OS processes, each owning 2 virtual CPU devices, form one
4-device mesh via ``jax.distributed`` (gloo collectives on CPU — the
same program runs over NCCL on GPUs, SURVEY.md §2.3 collective
backend row) and run the sharded FX step end to end; each process
verifies its own addressable output shards vs golden.
"""

import os
import socket
import subprocess
import sys

import pytest

_HERE = os.path.dirname(os.path.abspath(__file__))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.mark.parametrize("mode", ["fx", "sp", "runner", "beam",
                                  "beam_ep", "verify", "ckpt",
                                  "fengine", "sp_runner"])
def test_multiprocess_step(mode, n_proc=2, dev_per_proc=2):
    port = _free_port()
    env = dict(os.environ,
               XLA_FLAGS=("--xla_force_host_platform_device_count="
                          f"{dev_per_proc}"),
               JAX_PLATFORMS="cpu")
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(_HERE, "_mp_fx_worker.py"),
         str(i), str(n_proc), str(port), mode],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env) for i in range(n_proc)]
    # drain CONCURRENTLY: a crashed worker filling its un-read pipe
    # would otherwise block while its peer waits on a collective, and
    # the sequential communicate() timeout would discard the one
    # traceback that explains the failure
    from concurrent.futures import ThreadPoolExecutor

    def drain(p):
        try:
            return p.communicate(timeout=300)[0]
        finally:
            if p.poll() is None:
                p.kill()

    with ThreadPoolExecutor(len(procs)) as ex:
        outs = list(ex.map(drain, procs))
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"proc {i}:\n{out}"
        assert "PASS" in out, f"proc {i}:\n{out}"


@pytest.mark.parametrize("config", ["fx64", "beam64"])
def test_podsim_contract_mesh(config):
    """16-device deployment rehearsal: 4 processes x 4 virtual devices =
    the 16-device contract mesh (BASELINE.json:5), running the
    PRODUCTION configs 4 and 5 (64 antennas dual-pol: corner-turn + CMAC
    + dump / multi-beam + incoherent sum) through verify_config — the
    entry `cli verify` uses.  Channel count is
    CI-scaled; the sharding (4 ants/device, 8 chans/device
    post-corner-turn, beam psum) and every collective edge are the
    deployment's own."""
    test_multiprocess_step(f"verify:{config}", n_proc=4, dev_per_proc=4)
