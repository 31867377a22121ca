"""The camera-scalar ABI of the record kernel and its ray generation.

Counterpart of two pieces of relativisticraytracer_tpu/ops/pallas_march.py:
`pack_camera_scalars` (:69-95) and the ray-gen semantics of
`_gen_tile_rays` (:194-268); its `_uv_planes` (:625-658) is
render/camera.uv_planes. The port works on (H, W) planes, not lane tiles,
so ray generation from the scalars is render/camera.generate_rays on the
camera those scalars describe; the CUDA record kernel (csrc/record.cu)
does the same arithmetic per thread.
"""

from __future__ import annotations

import numpy as np

from relativisticraytracer_tpu_torch.config import CameraEffects
from relativisticraytracer_tpu_torch.render.camera import CameraState, generate_rays


def pack_camera_scalars(camera: CameraState, effects: CameraEffects, time) -> np.ndarray:
    """float32[16] = [time, pos(3), forward(3), right(3), up(3),
    use_lens_distortion, distortion_amount, ca_eff]: the scalars the record
    kernel takes by value. ca_eff is the effective chromatic-aberration
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


def rays_from_scalars(scal: np.ndarray, width: int, height: int, device):
    """(origin, direction) Vec3 planes [height, width] for the packed
    camera: the record kernel's ray generation, in plain PyTorch."""
    s = np.asarray(scal, np.float32)
    cam = CameraState(pos=s[1:4], forward=s[4:7], right=s[7:10], up=s[10:13])
    effects = CameraEffects(use_lens_distortion=float(s[13]),
                            distortion_amount=float(s[14]))
    origin, rd, _, _ = generate_rays(width, height, cam, effects, device)
    return origin, rd
