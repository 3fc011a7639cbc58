"""The port's native edge runtime (``runtime/native.py`` +
``runtime/edge_runtime.cpp``, built by g++ into ``build/``) under the
contract of ``tests/test_runtime.py`` — FIFO order, drop-oldest, the TUM
reader, paced replay, ``rss_bytes`` — and the port's ``run_paced`` under
``tests/test_run_tum.py::test_paced_replay_drops_when_tracker_slow``.  The
tests skip where JAX's do: when g++ cannot build the runtime."""

import time

import numpy as np
import pytest

from rumi_slam_tpu.runtime import native as jnative
from rumi_slam_tpu_torch.examples.run_tum import run_paced
from rumi_slam_tpu_torch.runtime import native
from test_runtime import write_pgm


@pytest.fixture(autouse=True)
def built():
    if not native.available():
        pytest.skip(f"native runtime not built (no g++): {native.build_log[-300:]}")


@pytest.fixture()
def tum_dir(tmp_path):
    rng = np.random.default_rng(0)
    lines = ["# fake TUM dataset"]
    (tmp_path / "rgb").mkdir()
    for i in range(12):
        name = f"rgb/{i:04d}.pgm"
        write_pgm(tmp_path / name, rng.integers(0, 255, (24, 32), dtype=np.uint8))
        lines.append(f"{i * 0.033:.6f} {name}")
    (tmp_path / "rgb.txt").write_text("\n".join(lines))
    return tmp_path


def test_library_builds_into_build_dir():
    so = native._build()
    assert so is not None and so.parent == native.BUILD_DIR and so.suffix == ".so"
    assert not list(native._SRC.parent.glob("*.so"))


def test_push_pop_fifo():
    q = native.FrameQueue(8, 4, 6)
    for i in range(5):
        q.push(float(i), np.full((4, 6), i, np.float32))
    assert len(q) == 5
    t, f = q.pop()
    assert t == 0.0 and float(f[0, 0]) == 0.0
    t, f = q.pop()
    assert t == 1.0 and float(f[3, 5]) == 1.0
    q.close()


@pytest.mark.parametrize("lib", [native, jnative], ids=["port", "jax"])
def test_drop_oldest_when_full(lib):
    """Both packages' rings drop the same frames."""
    if not lib.available():
        pytest.skip("the JAX package's runtime did not build")
    q = lib.FrameQueue(4, 2, 2)
    for i in range(10):
        q.push(float(i), np.full((2, 2), i, np.float32))
    assert q.dropped == 6 and len(q) == 4
    got = [q.pop()[0] for _ in range(4)]
    assert got == [6.0, 7.0, 8.0, 9.0] and q.pop() is None
    q.close()


def test_push_rejects_a_frame_of_another_shape():
    q = native.FrameQueue(2, 2, 2)
    with pytest.raises(ValueError):
        q.push(0.0, np.zeros((3, 2), np.float32))
    assert q.pop() is None
    q.close()


def test_read_frames_as_jax(tum_dir):
    ds = native.TumDataset(str(tum_dir))
    assert len(ds) == 12
    img = ds.read(0)
    assert img.shape == (24, 32)
    assert abs(ds.timestamp(3) - 0.099) < 1e-6
    if jnative.available():
        jd = jnative.TumDataset(str(tum_dir))
        for i in (0, 5, 11):
            np.testing.assert_array_equal(ds.read(i), jd.read(i))
        jd.close()
    ds.close()
    with pytest.raises(FileNotFoundError):
        native.TumDataset(str(tum_dir / "missing"))


def test_paced_replay(tum_dir):
    ds = native.TumDataset(str(tum_dir))
    q = native.FrameQueue(32, 24, 32)
    ds.start_replay(q, pace=0.0)  # as fast as possible
    deadline = time.time() + 10.0
    got = []
    while len(got) < 12 and time.time() < deadline:
        item = q.pop()
        if item is not None:
            got.append(item[0])
        else:
            time.sleep(0.005)
    assert len(got) == 12
    assert got == sorted(got)
    ds.close()
    q.close()


def test_rss():
    assert native.rss_bytes() > 1024 * 1024


class _Seq:
    times = np.arange(40) / 30.0
    _rgb_paths = ["f.png"] * 40    # non-PNM -> python producer path

    def __len__(self):
        return 40

    def frame(self, i):
        return np.full((24, 32), float(i), np.float32), float(self.times[i])


class _SlowSlam:
    def __init__(self):
        self.tracked = []

    def track_monocular(self, img, t):
        self.tracked.append(t)
        time.sleep(0.08)       # 80 ms/frame vs 33 ms cadence


def test_paced_replay_drops_when_tracker_slow(tmp_path):
    """run_paced (native ring, drop-oldest): a tracker slower than the replay
    clock MUST lose frames, and the loss must be counted."""
    slam = _SlowSlam()
    drops, n_tracked = run_paced(slam, None, _Seq(), str(tmp_path), pace=1.0)
    assert drops > 0, "slow tracker must drop frames"
    assert n_tracked + drops == 40
    assert n_tracked == len(slam.tracked)


def test_paced_replay_native_producer(tum_dir):
    """Every frame PGM: the C++ replay thread produces, the frame shape comes
    from the native reader, and a tracker that keeps up loses nothing."""
    class Seq:
        _rgb_paths = [f"rgb/{i:04d}.pgm" for i in range(12)]

    class Fast:
        shapes = []

        def track_monocular(self, img, t):
            self.shapes.append(img.shape)

    slam = Fast()
    drops, n_tracked = run_paced(slam, None, Seq(), str(tum_dir), pace=4.0)
    assert (drops, n_tracked) == (0, 12)
    assert set(slam.shapes) == {(24, 32)}
