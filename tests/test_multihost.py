"""Multi-host smoke test (SURVEY.md section 4 class 4, 'multi-host:
jax.distributed with multiple local processes').

Spawns two local processes that jax.distributed.initialize against each
other on the CPU backend, build a shared 2-device mesh over the combined
process devices, and run one psum -- validating the multi-process path
that ShardedBank/ShardedScanner ride across several hosts. (On one GPU
host a single process drives every card and needs no initialization;
see tpudsp/parallel/multihost.py.) Skipped gracefully if the runtime
refuses local multi-process init."""

import os
import socket
import subprocess
import sys

import pytest


def _free_port() -> str:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return str(s.getsockname()[1])

_WORKER = r"""
import os, sys
import jax
jax.config.update("jax_platforms", "cpu")
pid = int(sys.argv[1]); nproc = int(sys.argv[2]); port = sys.argv[3]
jax.distributed.initialize(coordinator_address=f"127.0.0.1:{port}",
                           num_processes=nproc, process_id=pid)
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
import numpy as np
devs = jax.devices()
assert len(devs) == nproc, devs
mesh = Mesh(np.array(devs), ("time",))
x = jnp.arange(8.0)


def f(a):
    return jax.lax.psum(a, "time")


y = jax.jit(jax.shard_map(f, mesh=mesh, in_specs=P("time"), out_specs=P("time"),
                          check_vma=False))(
    jax.device_put(x, NamedSharding(mesh, P("time"))))
local = np.asarray(jax.device_get([s.data for s in y.addressable_shards][0]))
print("OK", pid, local.tolist(), flush=True)
"""


_SCANNER_WORKER = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax
jax.config.update("jax_platforms", "cpu")
pid = int(sys.argv[1]); nproc = int(sys.argv[2]); port = sys.argv[3]
jax.distributed.initialize(coordinator_address=f"127.0.0.1:{port}",
                           num_processes=nproc, process_id=pid)
import numpy as np
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
sys.path.insert(0, os.environ["TPUDSP_REPO"])
from tpudsp.chains.channelizer import (
    ChannelizedBank, ChannelizedBankConfig, ChannelizerConfig)
from tpudsp.parallel.mesh import CHANNEL_AXIS, TIME_AXIS
from tpudsp.parallel.multihost import ShardedScanner

devs = jax.devices()
assert len(devs) == 8, devs  # 2 processes x 4 local CPU devices
C = 32
cfg = ChannelizedBankConfig(
    channelizer=ChannelizerConfig(nchan=C, taps_per_branch=6,
                                  iq_rate=3_200_000.0),
    demod="fm", kd=0.25)
n = C * 2048
t = np.arange(n)
x = sum(np.exp(1j * (2 * np.pi * (c / C) * t
                     + 2 * np.pi * 0.1 / C * np.cumsum(
                         np.sin(2 * np.pi * 0.0004 * (i + 1) * t))))
        for i, c in enumerate((3, 11, 25)))
iq = (np.asarray(x) / 3).astype(np.complex64)

mesh = Mesh(np.array(devs).reshape(1, 8), (CHANNEL_AXIS, TIME_AXIS))
sc = ShardedScanner(cfg, mesh, block_len=n)
audio = sc(iq)
jax.block_until_ready(audio)

# reference: single-process bank on the same data (runs identically in
# both processes; each checks its addressable output shards)
ref = np.asarray(ChannelizedBank(cfg, block_len=n)(iq))
ok = True
for shard in audio.addressable_shards:
    got = np.asarray(shard.data)
    exp = ref[shard.index]
    err = np.abs(got - exp)
    ok &= float(err.max()) < 1e-3
print("OK" if ok else "MISMATCH", pid, flush=True)
assert ok
"""


@pytest.mark.skipif(os.environ.get("TPUDSP_SKIP_MULTIPROC") == "1",
                    reason="multi-process test disabled")
def test_two_process_sharded_scanner(tmp_path):
    """Config 5 end-to-end across two processes: the time-sharded scanner
    runs on a global 8-device mesh spanning both, with the boundary
    exchange crossing the process boundary, and matches the single-chip
    bank on every process's addressable shards."""
    port = _free_port()
    script = tmp_path / "scanner_worker.py"
    script.write_text(_SCANNER_WORKER)
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    env["JAX_PLATFORMS"] = "cpu"
    env["TPUDSP_REPO"] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(i), "2", port],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
        for i in range(2)]
    outs = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=240)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.skip("multi-process scanner timed out in this environment")
        outs.append((p.returncode, out, err))
    for rc, out, err in outs:
        if rc != 0 and ("coordinator" in err.lower() or "initialize" in err.lower()):
            pytest.skip(f"distributed runtime unavailable: {err[-200:]}")
        assert rc == 0, err[-800:]
        assert "OK" in out


@pytest.mark.skipif(os.environ.get("TPUDSP_SKIP_MULTIPROC") == "1",
                    reason="multi-process test disabled")
def test_two_process_distributed_psum(tmp_path):
    port = _free_port()
    script = tmp_path / "worker.py"
    script.write_text(_WORKER)
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)  # one device per process
    env["JAX_PLATFORMS"] = "cpu"
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(i), "2", port],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
        for i in range(2)]
    outs = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=120)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.skip("multi-process init timed out in this environment")
        outs.append((p.returncode, out, err))
    for rc, out, err in outs:
        if rc != 0 and "coordinator" in err.lower():
            pytest.skip(f"distributed runtime unavailable: {err[-200:]}")
        assert rc == 0, err[-500:]
        assert "OK" in out
