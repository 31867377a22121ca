"""The frame program (port of relativisticraytracer_tpu.render.pipeline).

`render_frame` is the plain path: ray gen -> masked geodesic march ->
radiative transfer -> skybox composite -> post FX -> tone map -> uint8
pack, all plain PyTorch. `Renderer` drives the frame program its
settings name on the device it is given (a CUDA card unless the caller
asks for the CPU): ops/pallas_compact.render_frame_pallas_compact (record,
replay and sky kernels; the fused inline march where there is no sky or no
medium) for `media_pass="compact"`, ops/pallas_march.render_frame_pallas
(the fused inline march) for `media_pass="inline"`. On the CPU each kernel
is its plain PyTorch version. Nothing probes the machine.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from relativisticraytracer_tpu_torch.config import (
    CameraEffects,
    RenderSettings,
    SceneConfig,
)
from relativisticraytracer_tpu_torch.core.vecmath import Vec3
from relativisticraytracer_tpu_torch.ops.pallas_compact import render_frame_pallas_compact
from relativisticraytracer_tpu_torch.ops.pallas_march import _time_tensor, render_frame_pallas
from relativisticraytracer_tpu_torch.render.camera import CameraState, generate_rays
from relativisticraytracer_tpu_torch.render.march import render_hdr
from relativisticraytracer_tpu_torch.render.postfx import (
    apply_effects_and_tonemap,
    downsample_box,
    pack_rgba8,
)
from relativisticraytracer_tpu_torch.render.skybox import (
    Skybox,
    sample_sky_fast,
    skybox_from_array,
)


def render_frame(
    scene: SceneConfig,
    settings: RenderSettings,
    camera: CameraState,
    effects: CameraEffects,
    time,
    sky: Optional[Skybox],
    *,
    device="cuda",
) -> torch.Tensor:
    """Render one frame on `device` with the plain march -> uint8[H, W, 4],
    top-down row order."""
    ss = settings.supersample
    origin, direction, uv_x, uv_y = generate_rays(
        settings.width * ss, settings.height * ss, camera, effects, device
    )
    if sky is not None:
        def sky_fn(d: Vec3) -> Vec3:
            return sample_sky_fast(sky, d, effects)
    else:
        def sky_fn(d: Vec3) -> Vec3:
            zero = torch.zeros_like(d.x)
            return Vec3(zero, zero, zero)

    hdr, _ = render_hdr(scene, origin, direction, _time_tensor(time, device),
                        sky_fn, max_steps=settings.resolved_max_steps(scene))
    ldr = apply_effects_and_tonemap(hdr, uv_x, uv_y, effects, scene.exposure)
    return pack_rgba8(downsample_box(ldr, ss))


class Renderer:
    """Host-side driver of the frame program on one device.

    Keeps the skybox resident on that device (the one-time upload, analog
    of main.cpp:247-248). `device` decides the path: "cuda[:N]" (the
    default) launches the kernels, "cpu" runs their plain versions.
    `render_on` renders on another device with a per-device sky replica."""

    def __init__(
        self,
        scene: SceneConfig = SceneConfig(),
        settings: RenderSettings = RenderSettings(),
        skybox_rgba: Optional[np.ndarray] = None,
        skybox: Optional[Skybox] = None,
        *,
        device="cuda",
    ):
        self.scene = scene
        self.settings = settings
        self.device = torch.device(device)
        self._fn = (render_frame_pallas_compact if settings.media_pass == "compact"
                    else render_frame_pallas)
        self._sky_cache: dict = {}
        # `skybox` shares an already-built texture; `skybox_rgba` uploads a
        # host array.
        self.sky: Optional[Skybox] = None if skybox is None else skybox.to(self.device)
        if skybox is None and skybox_rgba is not None:
            self.sky = skybox_from_array(skybox_rgba, self.device)

    def render(
        self,
        camera: CameraState,
        effects: Optional[CameraEffects] = None,
        time: float = 0.0,
    ) -> torch.Tensor:
        """Returns the uint8[H, W, 4] frame on the renderer's device."""
        return self.render_on(None, camera, effects, time)

    def render_np(self, camera, effects=None, time: float = 0.0) -> np.ndarray:
        """Render and fetch to host (the analog of the PBO readback)."""
        return self.render(camera, effects, time).cpu().numpy()

    def _sky_on(self, device: torch.device) -> Optional[Skybox]:
        """Per-device replica of the skybox (one upload per device)."""
        if self.sky is None or device == self.device:
            return self.sky
        if device not in self._sky_cache:
            self._sky_cache[device] = self.sky.to(device)
        return self._sky_cache[device]

    def render_on(self, device, camera: CameraState,
                  effects: Optional[CameraEffects] = None,
                  time: float = 0.0) -> torch.Tensor:
        """One frame on `device` (None: the renderer's own), returned on
        that device without waiting for it. Frames are independent, so an
        animation can deal them round-robin to several cards with no
        communication (reference recording loop: main.cpp:505-529)."""
        if effects is None:
            effects = CameraEffects()
        device = self.device if device is None else torch.device(device)
        return self._fn(self.scene, self.settings, camera, effects, time,
                        self._sky_on(device), device=device)
