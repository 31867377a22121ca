"""The fused inline march and its frames (port of
relativisticraytracer_tpu.ops.pallas_march).

One march loop does everything per ray: horizon capture, adaptive step,
RK4, the disk and cloud shading under the ray's skip probes, front-to-back
compositing, escape. The JAX module runs it in three Pallas kernels that
differ only in prologue and epilogue; csrc/march.cu has one CUDA kernel
for each:

  `march_pallas_camera_sky`  rays generated from the camera scalars;
                             (I, T) and the sky coordinates of the final
                             direction. The `media_pass="inline"` frame,
                             and the frame with no medium.
  `march_pallas_camera`      rays from the camera scalars; (I, T, hit, v).
                             The frame with no sky.
  `march_pallas`             rays from (H, W) planes; (I, T, hit, v). The
                             non-compact branch of parallel/sharding.py.

Each wrapper launches its kernel for a CUDA device and runs its plain
version, render/march.march, for the CPU; nothing else picks. The lane
tiles, `BLOCK_H`/`BLOCK_W`, `UNROLL` and `GROUP_ROWS` of the JAX module
are TPU mechanisms: the port works on (H, W) planes.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from relativisticraytracer_tpu_torch.config import (
    CameraEffects,
    RenderSettings,
    SceneConfig,
)
from relativisticraytracer_tpu_torch.core.vecmath import Vec3, normalize
from relativisticraytracer_tpu_torch.ops import cuda_lib
from relativisticraytracer_tpu_torch.ops.camera_rays import (
    pack_camera_scalars,
    rays_from_scalars,
)
from relativisticraytracer_tpu_torch.render.camera import uv_planes
from relativisticraytracer_tpu_torch.render.march import march
from relativisticraytracer_tpu_torch.render.postfx import (
    apply_effects_and_tonemap,
    downsample_box,
    pack_rgba8,
)
from relativisticraytracer_tpu_torch.render.skybox import (
    Skybox,
    gather_sky_coords,
    sky_coords,
)

# (intensity, transmittance, hit, final velocity), each [H, W]
MarchResult = Tuple[Vec3, torch.Tensor, torch.Tensor, Vec3]
# (intensity, transmittance, idx, fx, fy): idx/fx/fy are [3, H, W] per
# channel (r, g, b)
SkyMarchResult = Tuple[Vec3, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def _time_tensor(time, device) -> torch.Tensor:
    """The sim clock as a float32 scalar tensor: products such as
    `time * 0.35` are then float32 products, as in the JAX package."""
    return torch.as_tensor(time, dtype=torch.float32, device=device).reshape(())


def _device(device) -> torch.device:
    device = torch.device(device)
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device}")
    return device


# --------------------------------------------------------------------------
# Plain versions (any device)
# --------------------------------------------------------------------------


def _march_plain(scene: SceneConfig, origin: Vec3, direction: Vec3, time,
                 max_steps: int) -> MarchResult:
    """The plane march in plain PyTorch: render/march.march."""
    st = march(scene, origin, direction, _time_tensor(time, origin.x.device), max_steps)
    return st.intensity, st.transmittance, st.hit_horizon, st.v


def _march_camera_plain(scene: SceneConfig, scal, width: int, height: int,
                        max_steps: int, device) -> MarchResult:
    origin, direction = rays_from_scalars(scal, width, height, device)
    return _march_plain(scene, origin, direction, float(scal[0]), max_steps)


def _march_camera_sky_plain(scene: SceneConfig, scal, width: int, height: int,
                            max_steps: int, sky_h: int, sky_w: int,
                            device) -> SkyMarchResult:
    intensity, trans, _, vel = _march_camera_plain(scene, scal, width, height,
                                                   max_steps, device)
    coords = sky_coords(normalize(vel), float(scal[15]), sky_h, sky_w)
    idx, fx, fy = (torch.stack([c[j] for c in coords]) for j in range(3))
    return intensity, trans, idx, fx, fy


# --------------------------------------------------------------------------
# Kernels (csrc/march.cu)
# --------------------------------------------------------------------------


def _planes(shape, device, *leading):
    return [torch.empty(tuple(lead) + tuple(shape), dtype=torch.float32, device=device)
            for lead in leading]


def _state(intensity, trans, hit, vel) -> MarchResult:
    return Vec3(*intensity), trans, hit > 0.5, Vec3(*vel)


def _march_planes_cuda(scene: SceneConfig, origin: Vec3, direction: Vec3, time,
                       max_steps: int, lib=None) -> MarchResult:
    device = origin.x.device
    shape = tuple(origin.x.shape)
    rays = torch.stack(list(origin) + list(direction))
    intensity, trans, hit, vel = _planes(shape, device, (3,), (), (), (3,))
    cuda_lib.resolve(lib).march_planes(
        cuda_lib.scene_consts(scene), float(np.float32(time)), max_steps, rays,
        intensity, trans, hit, vel, cuda_lib.current_stream(device))
    return _state(intensity, trans, hit, vel)


def _march_camera_cuda(scene: SceneConfig, scal, width: int, height: int,
                       max_steps: int, device, lib=None) -> MarchResult:
    intensity, trans, hit, vel = _planes((height, width), device, (3,), (), (), (3,))
    cuda_lib.resolve(lib).march_camera(
        cuda_lib.scene_consts(scene), cuda_lib.cam_scalars(scal), max_steps,
        intensity, trans, hit, vel, cuda_lib.current_stream(device))
    return _state(intensity, trans, hit, vel)


def _march_camera_sky_cuda(scene: SceneConfig, scal, width: int, height: int,
                           max_steps: int, sky_h: int, sky_w: int, device,
                           lib=None) -> SkyMarchResult:
    intensity, trans, fx, fy = _planes((height, width), device, (3,), (), (3,), (3,))
    idx = torch.empty((3, height, width), dtype=torch.int32, device=device)
    cuda_lib.resolve(lib).march_sky(
        cuda_lib.scene_consts(scene), cuda_lib.cam_scalars(scal), max_steps, sky_h, sky_w,
        intensity, trans, idx, fx, fy, cuda_lib.current_stream(device))
    return Vec3(*intensity), trans, idx, fx, fy


# --------------------------------------------------------------------------
# Entry points
# --------------------------------------------------------------------------


def march_pallas(scene: SceneConfig, origin: Vec3, direction: Vec3, time,
                 max_steps: int, *, lib=None) -> MarchResult:
    """March rays given as (H, W) planes on their device: the CUDA plane
    kernel for CUDA tensors, the plain march for CPU tensors. Returns
    (intensity Vec3, transmittance, hit bool, final velocity Vec3).
    `lib` picks a kernel build (ops/cuda_lib.kernels); None is the default."""
    device = _device(origin.x.device)
    if device.type == "cuda":
        return _march_planes_cuda(scene, origin, direction, time, max_steps, lib)
    return _march_plain(scene, origin, direction, time, max_steps)


def march_pallas_camera(scene: SceneConfig, camera, effects: CameraEffects, time,
                        width: int, height: int, max_steps: int, *,
                        device="cuda", lib=None) -> MarchResult:
    """March the (height, width) frame with rays generated from the camera
    on `device`. Same outputs as march_pallas."""
    device = _device(device)
    scal = pack_camera_scalars(camera, effects, time)
    if device.type == "cuda":
        return _march_camera_cuda(scene, scal, width, height, max_steps, device, lib)
    return _march_camera_plain(scene, scal, width, height, max_steps, device)


def march_pallas_camera_sky(scene: SceneConfig, camera, effects: CameraEffects, time,
                            width: int, height: int, max_steps: int, sky_h: int,
                            sky_w: int, *, device="cuda", lib=None) -> SkyMarchResult:
    """March the (height, width) frame with rays generated from the camera,
    and address the (sky_h, sky_w) sky at each ray's final direction.
    Returns (intensity Vec3, transmittance, idx, fx, fy) with idx/fx/fy
    [3, H, W] per channel; captured rays have transmittance exactly 0."""
    device = _device(device)
    scal = pack_camera_scalars(camera, effects, time)
    args = (scene, scal, width, height, max_steps, sky_h, sky_w, device)
    if device.type == "cuda":
        return _march_camera_sky_cuda(*args, lib)
    return _march_camera_sky_plain(*args)


def render_frame_pallas(scene: SceneConfig, settings: RenderSettings, camera,
                        effects: CameraEffects, time, sky: Optional[Skybox], *,
                        device="cuda", lib=None) -> torch.Tensor:
    """The frame with the media shaded inline in the march: uint8
    [H, W, 4]. The sky is gathered at the march's sky coordinates
    (render/skybox.gather_sky_coords); captured rays need no mask, their
    transmittance is exactly 0 (raymarcher.cu:49)."""
    if sky is None:
        return _render_frame_pallas_nosky(scene, settings, camera, effects, time,
                                          device=device, lib=lib)
    device = _device(device)
    ss = settings.supersample
    w, h = settings.width * ss, settings.height * ss
    intensity, trans, idx, fx, fy = march_pallas_camera_sky(
        scene, camera, effects, time, w, h, settings.resolved_max_steps(scene),
        *sky.shape, device=device, lib=lib)
    bg = gather_sky_coords(sky, tuple(zip(idx, fx, fy)), effects)
    hdr = Vec3(
        intensity.x + bg.x * trans,
        intensity.y + bg.y * trans,
        intensity.z + bg.z * trans,
    )
    uv_x, uv_y = uv_planes(w, h, effects, device)
    ldr = apply_effects_and_tonemap(hdr, uv_x, uv_y, effects, scene.exposure)
    return pack_rgba8(downsample_box(ldr, ss))


def _render_frame_pallas_nosky(scene: SceneConfig, settings: RenderSettings, camera,
                               effects: CameraEffects, time, *, device="cuda",
                               lib=None) -> torch.Tensor:
    """The frame with no sky (black background): hdr = I."""
    device = _device(device)
    ss = settings.supersample
    w, h = settings.width * ss, settings.height * ss
    intensity, _, _, _ = march_pallas_camera(
        scene, camera, effects, time, w, h, settings.resolved_max_steps(scene),
        device=device, lib=lib)
    uv_x, uv_y = uv_planes(w, h, effects, device)
    ldr = apply_effects_and_tonemap(intensity, uv_x, uv_y, effects, scene.exposure)
    return pack_rgba8(downsample_box(ldr, ss))
