"""State carried across from the JAX package.

The JAX package's state is handed over as numpy arrays and plain dicts
(for example `dataclasses.asdict(scene)`, `np.asarray(camera.pos)`,
`np.asarray(skybox.qr)`), so this module needs no JAX. Both packages can
then render from identical inputs.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Optional

import numpy as np
import torch

from relativisticraytracer_tpu_torch.config import CameraEffects, SceneConfig
from relativisticraytracer_tpu_torch.render.camera import CameraState
from relativisticraytracer_tpu_torch.render.skybox import Skybox

_TUPLE_FIELDS = ("spin_axis", "mass_pos")


def scene_from_dict(fields: Mapping) -> SceneConfig:
    """SceneConfig from the JAX SceneConfig's fields (name for name)."""
    kw = dict(fields)
    for name in _TUPLE_FIELDS:
        if name in kw:
            kw[name] = tuple(float(c) for c in kw[name])
    return SceneConfig(**kw)


def camera_from_arrays(pos, forward, right, up) -> CameraState:
    """CameraState from the JAX CameraState's float32[3] arrays."""
    return CameraState(*(np.asarray(a, np.float32).reshape(3).copy()
                         for a in (pos, forward, right, up)))


def effects_from_dict(fields: Mapping) -> CameraEffects:
    """CameraEffects from the JAX CameraEffects' scalar fields."""
    names = {f.name for f in dataclasses.fields(CameraEffects)}
    return CameraEffects(**{k: float(np.float32(v)) for k, v in fields.items()
                            if k in names})


def skybox_from_planes(qr, qg, qb, q4: Optional[np.ndarray] = None, *,
                       device) -> Skybox:
    """Skybox on `device` from the JAX Skybox's uint32 quad planes. The
    bits are kept; the port stores them as int32 (torch has no uint32
    shifts on the CPU)."""
    def plane(a):
        a = np.ascontiguousarray(np.asarray(a))
        if a.dtype != np.uint32:
            raise ValueError(f"quad planes must be uint32, got {a.dtype}")
        return torch.from_numpy(a.view(np.int32).copy()).to(device)

    return Skybox(plane(qr), plane(qg), plane(qb),
                  None if q4 is None else plane(q4))
