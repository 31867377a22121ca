"""The camera-scalar ABI of the ray-generating kernels, and their ray
generation.

Counterpart of two pieces of relativisticraytracer_tpu/ops/pallas_march.py:
`pack_camera_scalars` (:69-95) and the ray-gen semantics of
`_gen_tile_rays` (:194-268), shard origin and strip maps included; its
`_uv_planes` (:625-658) is render/camera.uv_planes. The port works on
(H, W) planes, not lane tiles, so ray generation from the scalars is
render/camera's on the camera those scalars describe; the CUDA kernels do
the same arithmetic per thread (csrc/march_common.cuh::gen_ray).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from relativisticraytracer_tpu_torch.config import CameraEffects
from relativisticraytracer_tpu_torch.render.camera import (
    CameraState,
    rays_from_uv,
    uv_planes,
)


def pack_camera_scalars(camera: CameraState, effects: CameraEffects, time) -> np.ndarray:
    """float32[16] = [time, pos(3), forward(3), right(3), up(3),
    use_lens_distortion, distortion_amount, ca_eff]: the scalars the record
    and fused march kernels take by value. ca_eff is the effective chromatic-aberration
    offset (0.0 while the effect is off)."""
    return np.concatenate([
        np.asarray([time], np.float32),
        np.asarray(camera.pos, np.float32).reshape(3),
        np.asarray(camera.forward, np.float32).reshape(3),
        np.asarray(camera.right, np.float32).reshape(3),
        np.asarray(camera.up, np.float32).reshape(3),
        np.asarray([effects.use_lens_distortion, effects.distortion_amount,
                    effects.ca_offset()], np.float32),
    ])


def rays_from_scalars(scal: np.ndarray, width: int, height: int, device, origin=None,
                      img_w: Optional[int] = None, img_h: Optional[int] = None,
                      strips=None, cstrips=None):
    """(origin, direction) Vec3 planes [height, width] for the packed
    camera: the kernels' ray generation (csrc/march_common.cuh::gen_ray),
    in plain PyTorch. `origin`, `img_w`/`img_h`, `strips` and `cstrips`
    place the planes inside a larger frame as render/camera.uv_planes
    does (a shard of parallel/sharding.py)."""
    s = np.asarray(scal, np.float32)
    cam = CameraState(pos=s[1:4], forward=s[4:7], right=s[7:10], up=s[10:13])
    effects = CameraEffects(use_lens_distortion=float(s[13]),
                            distortion_amount=float(s[14]))
    uv_x, uv_y = uv_planes(width, height, effects, device, origin=origin, img_w=img_w,
                           img_h=img_h, strips=strips, cstrips=cstrips)
    return rays_from_uv(uv_x, uv_y, cam, width if img_w is None else img_w,
                        height if img_h is None else img_h)
