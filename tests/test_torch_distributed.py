"""The port's process group and meshes (``parallel/distributed.py``) against
the JAX package's: the single-process contract, the mesh errors, and two
interpreters joined by ``initialize`` over localhost with ``gloo`` (the
counterpart of ``tests/test_distributed.py``, where JAX's two processes of
two virtual devices each form a ``(2, 2)`` mesh; PyTorch runs one rank per
device, so the port's two processes form a ``(2, 1)`` mesh)."""

import os
import socket
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from rumi_slam_tpu.parallel import distributed as jD
from rumi_slam_tpu_torch.parallel import distributed as tD

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_WORKER = r"""
import os, sys
sys.path.insert(0, os.environ["RUMI_REPO"])
import torch
import torch.distributed as dist
from rumi_slam_tpu_torch.parallel import distributed

assert distributed.initialize(), "env contract did not trigger init"
assert dist.get_world_size() == 2 and dist.get_backend() == "gloo"
mesh = distributed.global_mesh()
assert tuple(mesh.mesh.shape) == (2, 1), mesh.mesh.shape
assert mesh.mesh_dim_names == ("host", "chip")
# each rank contributes [r+1, r+1]; the sum crosses processes on "host"
x = torch.full((2,), float(dist.get_rank() + 1))
dist.all_reduce(x, group=mesh.get_group("host"))
got = float(x.sum())
assert got == 6.0, got
print("DIST_OK", dist.get_rank(), flush=True)
dist.destroy_process_group()
"""


def _clear_env(monkeypatch):
    for k in ("RUMI_COORD", "RUMI_NUM_PROCS", "RUMI_PROC_ID"):
        monkeypatch.delenv(k, raising=False)


def test_initialize_is_a_no_op_in_one_process(monkeypatch):
    _clear_env(monkeypatch)
    assert tD.initialize() is False
    assert jD.initialize() is False
    assert tD.initialize("127.0.0.1:1", 1, 0) is False     # one process: nothing to join
    assert not torch.distributed.is_initialized()


def test_ba_mesh_and_local_devices_on_this_host():
    """No card here: the coordinator takes the dense global BA, as JAX does
    on one device."""
    if torch.cuda.is_available():
        assert tD.process_local_devices() == [torch.device("cuda", i)
                                              for i in range(torch.cuda.device_count())]
        mesh = tD.ba_mesh()
        assert (mesh is None) == (torch.cuda.device_count() < 2)
        return
    assert tD.ba_mesh() is None and tD.ba_mesh(8) is None
    assert tD.process_local_devices() == [torch.device("cpu")]
    assert tD.BaMesh("cpu", 8).size == 8


@pytest.mark.parametrize("hosts", [3, 16])
def test_global_mesh_raises_as_jax(hosts):
    """The same errors for a mesh the devices cannot fill: JAX over its 8
    virtual devices, the port's shape rule over 8 ranks."""
    if len(jax.devices()) != 8:
        pytest.skip("needs the 8-device virtual CPU mesh of tests/conftest.py")
    with pytest.raises(ValueError) as ej:
        jD.global_mesh(hosts)
    with pytest.raises(ValueError) as et:
        tD.mesh_shape(8, hosts, 1)
    assert str(et.value) == str(ej.value)


def test_global_mesh_shapes():
    """One process, one device: more hosts than devices raises before any
    group is made; the shape rule gives one entry per rank."""
    with pytest.raises(ValueError, match="2 hosts requested but only 1 devices"):
        tD.global_mesh(2)
    assert tD.mesh_shape(2, None, 2) == (2, 1)      # JAX: (2, 2) with 2 devices a process
    assert tD.mesh_shape(8, 2, 2) == (2, 4)
    assert tD.mesh_shape(1, None, 1) == (1, 1)


def test_two_process_gloo_all_reduce():
    env_base = dict(os.environ)
    env_base["PYTHONPATH"] = REPO
    env_base["RUMI_REPO"] = REPO
    env_base["GLOO_SOCKET_IFNAME"] = "lo"
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = []
    for pid in range(2):
        env = dict(env_base)
        env["RUMI_COORD"] = f"127.0.0.1:{port}"
        env["RUMI_NUM_PROCS"] = "2"
        env["RUMI_PROC_ID"] = str(pid)
        procs.append(subprocess.Popen([sys.executable, "-c", _WORKER], env=env,
                                      stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    try:
        outs = [p.communicate(timeout=120) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, f"worker failed:\n{out}\n{err}"
        assert "DIST_OK" in out
    assert np.all([("DIST_OK %d" % r) in o for r, (o, _) in enumerate(outs)])
