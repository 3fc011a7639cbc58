"""YAML settings reader and per-dataset presets (a copy of
``rumi_slam_tpu/io/settings.py``, which is JAX-free itself but sits in a
package whose import runs JAX).

The OpenCV ``%YAML:1.0`` dialect differs from strict YAML only in its header
line and in flow-style matrices; this parser handles the dotted-key scalar
subset that the reference system's settings files use, with no yaml
dependency.  :data:`PRESETS` holds the calibrations of the reference
system's dataset files (TUM1/2/3, EuRoC, ICL).
"""

from __future__ import annotations

import dataclasses
import re
from pathlib import Path

from ..config import CameraConfig, Config, ORBConfig


def parse_opencv_yaml(path) -> dict:
    """Parse the dotted-key scalar subset of an OpenCV-YAML settings file.

    Returns a flat dict key -> int | float | str.
    """
    out: dict = {}
    txt = Path(path).read_text()
    for line in txt.splitlines():
        line = line.split("#", 1)[0].strip()
        if not line or line.startswith("%YAML"):
            continue
        m = re.match(r"^([A-Za-z0-9_.]+)\s*:\s*(.+)$", line)
        if not m:
            continue
        key, raw = m.group(1), m.group(2).strip()
        if raw.startswith('"') and raw.endswith('"'):
            out[key] = raw[1:-1]
            continue
        try:
            out[key] = int(raw)
        except ValueError:
            try:
                out[key] = float(raw)
            except ValueError:
                out[key] = raw
    return out


def config_from_settings(d: dict, base: Config | None = None) -> Config:
    """Build a Config from parsed reference-style settings; missing keys keep
    the ``base`` values.  ``Camera.bf`` sets the baseline (bf / fx);
    ``Camera.type: KannalaBrandt8`` reads k1..k4 as the fisheye polynomial
    and zeroes the radtan coefficients."""
    base = base or Config()

    def g(key, default):
        return d.get(key, default)

    cam = dataclasses.replace(
        base.camera,
        fx=float(g("Camera1.fx", g("Camera.fx", base.camera.fx))),
        fy=float(g("Camera1.fy", g("Camera.fy", base.camera.fy))),
        cx=float(g("Camera1.cx", g("Camera.cx", base.camera.cx))),
        cy=float(g("Camera1.cy", g("Camera.cy", base.camera.cy))),
        width=int(g("Camera.width", base.camera.width)),
        height=int(g("Camera.height", base.camera.height)),
        fps=float(g("Camera.fps", base.camera.fps)),
        # stereo/RGB-D fields (Settings.cc readImageInfo: Camera.bf etc.)
        baseline=(
            float(g("Camera.bf", 0.0)) / float(g("Camera1.fx", base.camera.fx))
            if "Camera.bf" in d
            else base.camera.baseline
        ),
        th_depth=float(g("Stereo.ThDepth", g("RGBD.ThDepth", base.camera.th_depth))),
        depth_factor=float(g("RGBD.DepthMapFactor", base.camera.depth_factor)),
        # radtan distortion (Settings.cc readCamera1 k1/k2/p1/p2[/k3])
        k1=float(g("Camera1.k1", base.camera.k1)),
        k2=float(g("Camera1.k2", base.camera.k2)),
        p1=float(g("Camera1.p1", base.camera.p1)),
        p2=float(g("Camera1.p2", base.camera.p2)),
        k3=float(g("Camera1.k3", base.camera.k3)),
    )
    # Camera.type KannalaBrandt8: k1..k4 are the fisheye polynomial
    # coefficients, not radtan (Settings.cc readCamera1 fisheye branch)
    if str(g("Camera.type", "PinHole")).lower().startswith("kannala"):
        cam = dataclasses.replace(
            cam, model="kb8",
            kb_coeffs=(float(g("Camera1.k1", 0.0)), float(g("Camera1.k2", 0.0)),
                       float(g("Camera1.k3", 0.0)), float(g("Camera1.k4", 0.0))),
            k1=0.0, k2=0.0, p1=0.0, p2=0.0, k3=0.0,
        )
    orb = dataclasses.replace(
        base.orb,
        n_features=int(g("ORBextractor.nFeatures", base.orb.n_features)),
        n_levels=int(g("ORBextractor.nLevels", base.orb.n_levels)),
        scale_factor=float(g("ORBextractor.scaleFactor", base.orb.scale_factor)),
        ini_th_fast=float(g("ORBextractor.iniThFAST", base.orb.ini_th_fast)),
        min_th_fast=float(g("ORBextractor.minThFAST", base.orb.min_th_fast)),
    )
    return dataclasses.replace(base, camera=cam, orb=orb)


def load_settings(path, base: Config | None = None) -> Config:
    """Read a reference-format YAML settings file into a Config."""
    return config_from_settings(parse_opencv_yaml(path), base)


# --- dataset presets (the reference system's config/<name>.yaml) ----------

def _preset(fx, fy, cx, cy, *, width=640, height=480, fps=30.0,
            n_features=1000):
    return Config(
        camera=CameraConfig(fx=fx, fy=fy, cx=cx, cy=cy, width=width,
                            height=height, fps=fps),
        orb=ORBConfig(n_features=n_features),
    )


PRESETS: dict[str, Config] = {
    # config/TUM1.yaml
    "tum1": _preset(517.306408, 516.469215, 318.643040, 255.313989),
    # config/TUM2.yaml
    "tum2": _preset(520.908620, 521.007327, 325.141442, 249.701764),
    # config/TUM3.yaml (the headline fr3 sequences; nFeatures=2000 there)
    "tum3": _preset(535.4, 539.2, 320.1, 247.6, n_features=2000),
    # config/euroc.yaml
    "euroc": _preset(458.654, 457.296, 367.215, 248.375, width=752,
                     height=480, fps=20.0),
    # config/icl.yaml
    "icl": _preset(481.20, 480.00, 319.50, 239.50),
}


def preset(name: str) -> Config:
    """Per-dataset Config (the reference system's config/<name>.yaml)."""
    key = name.lower()
    if key not in PRESETS:
        raise KeyError(f"unknown preset {name!r}; have {sorted(PRESETS)}")
    return PRESETS[key]
