#!/usr/bin/env python
"""Render a single frame: the reference's default view, full quality.

    python relativisticraytracer_tpu_torch/examples/render_still.py [out.png]

Renders on the CUDA card; RRT_DEVICE names another device (cpu runs the
kernels' plain versions). RRT_EXAMPLE_SMOKE=1 shrinks everything (64x48,
16 steps, tiny sky) so CI can execute this script in seconds.
"""

import os
import sys

from relativisticraytracer_tpu_torch import Renderer, RenderSettings, SceneConfig
from relativisticraytracer_tpu_torch.io.image import load_skybox, save_png
from relativisticraytracer_tpu_torch.render.camera import camera_state_from_pose

SMOKE = os.environ.get("RRT_EXAMPLE_SMOKE") == "1"
DEVICE = os.environ.get("RRT_DEVICE", "cuda")
out = sys.argv[1] if len(sys.argv) > 1 else "still.png"

renderer = Renderer(
    SceneConfig(),                               # Sgr A* scene, config.h defaults
    RenderSettings(width=1920, height=1080)      # media_pass="compact": record/replay/sky
    if not SMOKE
    else RenderSettings(width=64, height=48, max_steps=16),
    skybox_rgba=load_skybox(                     # or load_skybox("my_equirect.jpg")
        None, fallback_shape=(1024, 2048) if not SMOKE else (32, 64), device=DEVICE
    ),
    device=DEVICE,
)
camera = camera_state_from_pose(pos=(0.0, 10.0, -60.0), yaw=0.0, pitch=-10.0)
save_png(out, renderer.render_np(camera, time=1.0))
print(f"wrote {out}")
