"""Camera state + primary-ray generation (port of relativisticraytracer_tpu.render.camera).

`CameraState` is the host camera ABI (reference: raymarcher.h:11-16):
position plus an orthonormal (forward, right, up) basis, as float32 numpy
arrays. `camera_state_from_pose` is the JAX package's host-numpy basis
construction, unchanged (reference: src/main.cpp:141-167).

Ray generation matches the reference kernel prologue (raymarcher.cu:20-34):
uv at pixel corners (x/width by division, not a reciprocal), optional
barrel-distortion pre-warp, NDC with aspect on u only, and
rd = normalize(forward + u*right + v*up). Rays are in top-down row order.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np
import torch

from relativisticraytracer_tpu_torch.config import CameraEffects
from relativisticraytracer_tpu_torch.core.vecmath import Vec3, fdiv, normalize
from relativisticraytracer_tpu_torch.render.postfx import apply_lens_distortion

_DEG2RAD = 3.14159 / 180.0  # reference uses 3.14159f here (main.cpp:142-143)


@dataclasses.dataclass
class CameraState:
    """pos/forward/right/up as float32[3] numpy arrays (host state)."""

    pos: np.ndarray
    forward: np.ndarray
    right: np.ndarray
    up: np.ndarray

    def replace(self, **kw) -> "CameraState":
        return dataclasses.replace(self, **kw)


def camera_state_from_pose(pos, yaw: float, pitch: float) -> CameraState:
    """Orthonormal camera basis from a fly-camera pose (reference:
    src/main.cpp:141-167). Host float32 math, identical to the JAX package.

    yaw/pitch in degrees; forward = (sin(yaw)cos(pitch), sin(pitch),
    cos(yaw)cos(pitch)); right = worldUp x forward; up = forward x right.
    """
    f32 = np.float32
    yaw_r = f32(yaw) * f32(_DEG2RAD)
    pitch_r = f32(pitch) * f32(_DEG2RAD)

    fwd = np.array(
        [
            math.sin(yaw_r) * math.cos(pitch_r),
            math.sin(pitch_r),
            math.cos(yaw_r) * math.cos(pitch_r),
        ],
        dtype=np.float32,
    )
    fwd = fwd / f32(np.sqrt(np.sum(fwd * fwd, dtype=np.float32)))

    world_up = np.array([0.0, 1.0, 0.0], dtype=np.float32)
    right = np.cross(world_up, fwd).astype(np.float32)
    right = right / f32(np.sqrt(np.sum(right * right, dtype=np.float32)))
    up = np.cross(fwd, right).astype(np.float32)

    return CameraState(
        pos=np.asarray(pos, dtype=np.float32).reshape(3),
        forward=fwd,
        right=right,
        up=up,
    )


def default_camera() -> CameraState:
    """Reference startup pose: pos (0, 10, -60), yaw 0, pitch -10."""
    return camera_state_from_pose((0.0, 10.0, -60.0), 0.0, -10.0)


def uv_planes(width: int, height: int, effects: CameraEffects, device,
              origin=None, img_w: Optional[int] = None, img_h: Optional[int] = None,
              strips: Optional[Tuple[int, int]] = None,
              cstrips: Optional[Tuple[int, int]] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The (possibly distorted) screen uv planes, float32[height, width]
    (raymarcher.cu:20-25); the vignette reuses them (raymarcher.cu:160).
    The JAX package's `ops/pallas_march._uv_planes` (:625-658).

    With `origin=(x0, y0)` the planes cover the (height, width) rectangle
    at that global pixel offset of an (img_h, img_w) frame, bitwise a
    slice of the full frame's planes (exact integer float adds, the same
    divisions). `strips=(sh, ystride)` maps local row r to global row
    (r // sh) * ystride + r % sh before the offset, `cstrips=(sw, xstride)`
    the columns likewise (strip-interleaved shards, parallel/sharding.py)."""
    xi = torch.arange(width, device=device)
    yi = torch.arange(height, device=device)
    if strips is not None:
        sh, ystride = strips
        yi = (yi // sh) * ystride + yi % sh
    if cstrips is not None:
        sw, xstride = cstrips
        xi = (xi // sw) * xstride + xi % sw
    xs = xi.to(torch.float32)
    ys = yi.to(torch.float32)
    if origin is not None:
        xs = xs + float(np.float32(origin[0]))
        ys = ys + float(np.float32(origin[1]))
    nw = float(width if img_w is None else img_w)
    nh = float(height if img_h is None else img_h)
    uv_x = fdiv(xs, nw)[None, :].expand(height, width)
    uv_y = fdiv(ys, nh)[:, None].expand(height, width)
    if effects.use_lens_distortion > 0.5:
        uv_x, uv_y = apply_lens_distortion(uv_x, uv_y, effects.distortion_amount)
    return uv_x, uv_y


def rays_from_uv(uv_x: torch.Tensor, uv_y: torch.Tensor, cam: CameraState,
                 img_w: int, img_h: int) -> Tuple[Vec3, Vec3]:
    """(origin, direction) planes for the given screen uv of an
    (img_h, img_w) frame: NDC with aspect on u only, rd = normalize(forward
    + u*right + v*up) (raymarcher.cu:26-34)."""
    height, width = uv_x.shape
    aspect = float(np.float32(img_w) / np.float32(img_h))
    u = (uv_x * 2.0 - 1.0) * aspect
    v = uv_y * 2.0 - 1.0

    f, r, up = ([float(c) for c in vec] for vec in (cam.forward, cam.right, cam.up))
    rd = normalize(
        Vec3(
            f[0] + u * r[0] + v * up[0],
            f[1] + u * r[1] + v * up[1],
            f[2] + u * r[2] + v * up[2],
        )
    )
    origin = Vec3(*(torch.full((height, width), float(c), dtype=torch.float32,
                               device=uv_x.device) for c in cam.pos))
    return origin, rd


def generate_rays(
    width: int,
    height: int,
    cam: CameraState,
    effects: CameraEffects,
    device,
) -> Tuple[Vec3, Vec3, torch.Tensor, torch.Tensor]:
    """Primary rays for every pixel, top-down row order, on `device`.

    Returns (origins, directions, uv_x, uv_y); each component is a
    float32[height, width] plane."""
    uv_x, uv_y = uv_planes(width, height, effects, device)
    origin, rd = rays_from_uv(uv_x, uv_y, cam, width, height)
    return origin, rd, uv_x, uv_y
