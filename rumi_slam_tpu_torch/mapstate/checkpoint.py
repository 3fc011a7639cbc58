"""MapState checkpoint/resume: an npz snapshot with an integrity checksum
(port of ``rumi_slam_tpu/mapstate/checkpoint.py``).

The container is the JAX package's, so a file written by either package
loads in the other: 8 bytes of header length (little endian), a JSON header
(``format_version`` 2, ``sha256`` of the payload, ``fields``, capacities),
then one compressed npz of every field.  Descriptors are written as uint32:
the port holds their bit pattern in int32 and reinterprets, never converts.
"""

from __future__ import annotations

import hashlib
import io
import json
from pathlib import Path

import numpy as np
import torch

from . import map_state as M

_FORMAT_VERSION = 2  # v2: kf_ur (stereo/RGB-D virtual right coordinates)


def save(ms: M.MapState, path: str | Path) -> str:
    """Write the checkpoint; returns the hex digest of the payload."""
    path = Path(path)
    buf = io.BytesIO()
    np.savez_compressed(buf, **M.to_numpy(ms))
    payload = buf.getvalue()
    digest = hashlib.sha256(payload).hexdigest()
    meta = {
        "format_version": _FORMAT_VERSION,
        "sha256": digest,
        "fields": list(ms._fields),
        "max_kf": int(ms.max_kf),
        "max_feat": int(ms.max_feat),
        "max_pt": int(ms.max_pt),
    }
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "wb") as f:
        header = json.dumps(meta).encode()
        f.write(len(header).to_bytes(8, "little"))
        f.write(header)
        f.write(payload)
    return digest


def load(path: str | Path, device="cuda") -> M.MapState:
    """Read and verify a checkpoint onto ``device`` (the card by default; a
    host without one raises, pass ``device="cpu"`` for the CPU).  Raises
    ``ValueError`` on a version or checksum mismatch."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"checkpoint.load: device {str(device)!r} asked for and no CUDA device is present "
            "(pass device=\"cpu\" to load onto the CPU)")
    with open(path, "rb") as f:
        hlen = int.from_bytes(f.read(8), "little")
        meta = json.loads(f.read(hlen).decode())
        payload = f.read()
    if meta["format_version"] != _FORMAT_VERSION:
        raise ValueError(f"unsupported checkpoint version {meta['format_version']}")
    if hashlib.sha256(payload).hexdigest() != meta["sha256"]:
        raise ValueError("checkpoint corrupt: sha256 mismatch")
    npz = np.load(io.BytesIO(payload))
    return M.from_numpy({name: npz[name] for name in meta["fields"]}, device)
