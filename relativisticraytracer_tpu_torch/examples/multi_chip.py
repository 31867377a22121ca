#!/usr/bin/env python
"""Tile one frame across every CUDA card (zero collectives; each card
renders its own tile). One card makes a 1x1 grid: the frame is one tile.
A grid may repeat a device, whose shards then run one after another.

Renders on the CUDA cards; RRT_DEVICE names the device of the sky upload
and, with RRT_EXAMPLE_SMOKE=1, the 8 grid cells (e.g. RRT_DEVICE=cpu), a
smaller frame so CI can execute this script."""

import os

from relativisticraytracer_tpu_torch import CameraEffects, RenderSettings, SceneConfig
from relativisticraytracer_tpu_torch.io.image import load_skybox, save_png
from relativisticraytracer_tpu_torch.parallel.sharding import make_mesh, make_sharded_renderer
from relativisticraytracer_tpu_torch.render.camera import camera_state_from_pose
from relativisticraytracer_tpu_torch.render.skybox import skybox_from_array

SMOKE = os.environ.get("RRT_EXAMPLE_SMOKE") == "1"
DEVICE = os.environ.get("RRT_DEVICE", "cuda")

# all CUDA cards, most-square (rows, cols) grid; the smoke run's 8 cells
# stand in for 8 cards
mesh = make_mesh([DEVICE] * 8 if SMOKE else None)
distinct = len(set(mesh.devices.flat))
print(f"mesh: {mesh.shape[0]}x{mesh.shape[1]} grid over {distinct} distinct device(s)"
      + (" (one card: the frame is one tile)" if mesh.devices.size == 1 else ""))

scene = SceneConfig(**({"max_steps": 16} if SMOKE else {}))
settings = (
    RenderSettings(width=1920, height=1080)
    if not SMOKE
    else RenderSettings(width=256, height=128, max_steps=16)
)
render = make_sharded_renderer(scene, settings, mesh)

camera = camera_state_from_pose((0.0, 10.0, -60.0), 0.0, -10.0)
sky = skybox_from_array(
    load_skybox(None, fallback_shape=(1024, 2048) if not SMOKE else (32, 64), device=DEVICE),
    DEVICE,
)
frame = render(camera, CameraEffects(), 1.0, sky)
print(f"frame: {tuple(frame.shape)} {frame.dtype} on {frame.device}")
# reassemble undoes the strip-interleaved device layout (on by default on
# the compact path) and is the identity when the assignment is contiguous
save_png("sharded.png", render.reassemble(frame))
