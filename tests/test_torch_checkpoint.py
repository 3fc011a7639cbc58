"""The port's map checkpoint (``mapstate/checkpoint.py``) against the JAX
package's: a file written by one package loads in the other, field for field
(exact), descriptors as uint32 words on disk; a corrupted payload raises; and
``SlamSystem.save_map``/``load_map`` round-trip a driven map.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rumi_slam_tpu.mapstate import checkpoint as jC
from rumi_slam_tpu.mapstate import map_state as jM
from rumi_slam_tpu_torch.config import tiny_config
from rumi_slam_tpu_torch.mapstate import checkpoint as tC
from rumi_slam_tpu_torch.mapstate import map_state as tM
from rumi_slam_tpu_torch.system import SlamSystem, TrackState

from torch_system_drive import mapping_inputs

torch.set_num_threads(1)


def random_map_numpy(seed=0, K=6, F=16, P=40):
    """A MapState as a dict of numpy arrays with every field filled from the
    seed, descriptors as uint32 with the top bit set in places."""
    rng = np.random.default_rng(seed)
    d = tM.to_numpy(tM.empty(K, F, P, device="cpu"))
    for name, a in d.items():
        if a.dtype == np.float32:
            d[name] = rng.normal(size=a.shape).astype(np.float32)
        elif a.dtype == np.bool_:
            d[name] = rng.uniform(size=a.shape) > 0.4
        elif a.dtype == np.uint32:
            d[name] = rng.integers(0, 2**32, size=a.shape, dtype=np.uint32)
        else:
            d[name] = rng.integers(-1, 30, size=a.shape).astype(np.int32)
    d["kf_desc"][0, 0, 0] = np.uint32(0xFFFFFFFF)
    return d


def assert_maps_equal(a: dict, b: dict):
    assert set(a) == set(b)
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_jax_checkpoint_loads_in_port(tmp_path):
    d = random_map_numpy(1)
    j_ms = jM.MapState(**{k: jnp.asarray(v) for k, v in d.items()})
    path = tmp_path / "jax.ckpt"
    digest = jC.save(j_ms, path)
    t_ms = tC.load(path, device="cpu")
    assert t_ms.kf_desc.dtype == torch.int32 and t_ms.n_kf.shape == ()
    assert_maps_equal(tM.to_numpy(t_ms), d)
    # written again by the port, the payload differs only by compression: the
    # header agrees on everything but the digest
    path2 = tmp_path / "port.ckpt"
    tC.save(t_ms, path2)
    h1, h2 = (_header(p) for p in (path, path2))
    assert h1["sha256"] == digest
    assert {k: v for k, v in h1.items() if k != "sha256"} == \
        {k: v for k, v in h2.items() if k != "sha256"}


def _header(path):
    with open(path, "rb") as f:
        n = int.from_bytes(f.read(8), "little")
        return json.loads(f.read(n).decode())


def test_port_checkpoint_loads_in_jax(tmp_path):
    d = random_map_numpy(2)
    t_ms = tM.from_numpy(d, device="cpu")
    path = tmp_path / "sub" / "port.ckpt"          # the directory is created
    digest = tC.save(t_ms, path)
    assert _header(path)["format_version"] == 2 and _header(path)["sha256"] == digest
    j_ms = jC.load(path)
    assert np.asarray(j_ms.kf_desc).dtype == np.uint32
    assert_maps_equal({k: np.asarray(v) for k, v in j_ms._asdict().items()}, d)
    # digest stable: saving the same map again gives the same bytes
    assert tC.save(t_ms, tmp_path / "again.ckpt") == digest


def test_tampered_payload_raises(tmp_path):
    path = tmp_path / "m.ckpt"
    tC.save(tM.from_numpy(random_map_numpy(3), device="cpu"), path)
    raw = bytearray(path.read_bytes())
    raw[-20] ^= 0x01
    path.write_bytes(bytes(raw))
    with pytest.raises(ValueError, match="sha256"):
        tC.load(path, device="cpu")
    with pytest.raises(ValueError, match="sha256"):
        jC.load(path)


def test_wrong_version_raises(tmp_path):
    path = tmp_path / "m.ckpt"
    tC.save(tM.from_numpy(random_map_numpy(4), device="cpu"), path)
    raw = path.read_bytes()
    n = int.from_bytes(raw[:8], "little")
    head = json.loads(raw[8:8 + n].decode())
    head["format_version"] = 1
    new = json.dumps(head).encode()
    path.write_bytes(len(new).to_bytes(8, "little") + new + raw[8 + n:])
    with pytest.raises(ValueError, match="version"):
        tC.load(path, device="cpu")


def test_load_defaults_to_the_card(tmp_path):
    path = tmp_path / "m.ckpt"
    tC.save(tM.from_numpy(random_map_numpy(5), device="cpu"), path)
    if torch.cuda.is_available():
        assert tC.load(path).kf_pose.is_cuda
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tC.load(path)


def test_system_save_and_load_map(tmp_path):
    _, slam, seq = mapping_inputs(12)
    path = slam.save_map(tmp_path / "atlas.ckpt")
    before = tM.to_numpy(slam.ms)
    other = SlamSystem(tiny_config(), device="cpu")
    other.load_map(path)
    assert_maps_equal(tM.to_numpy(other.ms), before)
    assert other.state == TrackState.RECENTLY_LOST
    assert other.n_maps_host == int(before["n_maps"])
    assert other.active_map_host == int(before["active_map"])
    assert other.last_kf_id == int(before["n_kf"]) - 1
    # the loaded system relocalises against the map on the next frame
    st = other.track_monocular(*seq.frame(11))
    assert st == TrackState.OK and other.stats["n_reloc"] == 1
