#!/usr/bin/env python
"""Render the "Gargantua Fly-By" cinematic path to video (resumable: rerun
after an interruption and it continues from the last flushed frame).

    python relativisticraytracer_tpu_torch/examples/render_animation.py [seconds]

Renders on the CUDA card; RRT_DEVICE names another device.
RRT_EXAMPLE_SMOKE=1 shrinks the job (64x48, 16 steps, 3 frames) so CI can
execute it.
"""

import os
import sys

from relativisticraytracer_tpu_torch import Renderer, RenderSettings, SceneConfig
from relativisticraytracer_tpu_torch.io.image import load_skybox
from relativisticraytracer_tpu_torch.paths import default_paths
from relativisticraytracer_tpu_torch.runtime.app import AnimationJob

SMOKE = os.environ.get("RRT_EXAMPLE_SMOKE") == "1"
DEVICE = os.environ.get("RRT_DEVICE", "cuda")
duration = float(sys.argv[1]) if len(sys.argv) > 1 else (5.0 if not SMOKE else 0.125)

renderer = Renderer(
    SceneConfig(),
    RenderSettings(width=1280, height=720)
    if not SMOKE
    else RenderSettings(width=64, height=48, max_steps=16),
    skybox_rgba=load_skybox(
        None, fallback_shape=(1024, 2048) if not SMOKE else (32, 64), device=DEVICE
    ),
    device=DEVICE,
)
job = AnimationJob(
    path=default_paths()[0],     # or build your own CameraPath from Keyframes
    renderer=renderer,
    fps=24,
    duration=duration,
    out_path="flyby.mp4",        # raw .rgba + encode sidecar if ffmpeg is absent
)
stats = job.run(progress=lambda k, n, ms: print(
    f"\r frame {k}/{n} ({ms:.0f} ms)", end="", flush=True))
print(f"\n{stats}")
