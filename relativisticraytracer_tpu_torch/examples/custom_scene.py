#!/usr/bin/env python
"""Customize the scene: a rapidly spinning hole with a fatter, brighter
disk, no dust clouds, chromatic aberration on, and a custom camera path.

Every SceneConfig field mirrors the reference's include/config.h knob of
the same name; the kernels read the scene's constants at each launch and
are instantiated on its spin and mass-position flags.

Renders on the CUDA card; RRT_DEVICE names another device.
RRT_EXAMPLE_SMOKE=1 shrinks the render so CI can execute this script."""

import os

from relativisticraytracer_tpu_torch import (
    CameraEffects,
    CameraPath,
    Keyframe,
    Renderer,
    RenderSettings,
    SceneConfig,
)
from relativisticraytracer_tpu_torch.io.image import load_skybox, save_png
from relativisticraytracer_tpu_torch.paths import interpolate_path
from relativisticraytracer_tpu_torch.render.camera import camera_state_from_pose

SMOKE = os.environ.get("RRT_EXAMPLE_SMOKE") == "1"
DEVICE = os.environ.get("RRT_DEVICE", "cuda")

scene = SceneConfig(
    spin_a=0.95,            # near-extremal frame dragging
    disk_h_m=1.2,           # thicker disk
    disk_luminosity=9.0,
    enable_clouds=False,
    **({"max_steps": 16} if SMOKE else {}),
)
effects = CameraEffects(use_chromatic_aberration=1.0, ca_amount=0.004)

my_path = CameraPath("dive", [
    Keyframe(0.0, (0.0, 20.0, -70.0), 0.0, -14.0),
    Keyframe(5.0, (10.0, 4.0, -25.0), -20.0, -6.0),
    Keyframe(10.0, (18.0, 1.0, 8.0), -95.0, -2.0),
])

renderer = Renderer(
    scene,
    RenderSettings(width=1280, height=720)
    if not SMOKE
    else RenderSettings(width=64, height=48, max_steps=16),
    skybox_rgba=load_skybox(
        None, fallback_shape=(1024, 2048) if not SMOKE else (32, 64), device=DEVICE
    ),
    device=DEVICE,
)
for t in (0.0, 5.0, 10.0):
    pos, yaw, pitch = interpolate_path(my_path, t)
    frame = renderer.render_np(camera_state_from_pose(pos, yaw, pitch), effects, t)
    save_png(f"custom_t{int(t)}.png", frame)
    print(f"wrote custom_t{int(t)}.png")
