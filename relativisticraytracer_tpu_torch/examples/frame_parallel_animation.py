#!/usr/bin/env python
"""Render an animation with whole frames round-robined across every CUDA
card: the throughput-scaling mode (zero communication, linear in cards).

Renders on the CUDA cards; RRT_DEVICE names the renderer's device and,
with RRT_EXAMPLE_SMOKE=1, the 8 devices frames are dealt to (e.g.
RRT_DEVICE=cpu), a smaller job so CI can execute this script.
"""

import os

import torch

from relativisticraytracer_tpu_torch import RenderSettings, SceneConfig
from relativisticraytracer_tpu_torch.io.image import load_skybox
from relativisticraytracer_tpu_torch.paths import default_paths
from relativisticraytracer_tpu_torch.render.pipeline import Renderer
from relativisticraytracer_tpu_torch.runtime.app import AnimationJob

SMOKE = os.environ.get("RRT_EXAMPLE_SMOKE") == "1"
DEVICE = os.environ.get("RRT_DEVICE", "cuda")

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
devices = ([DEVICE] * 8 if SMOKE
           else [torch.device("cuda", i) for i in range(torch.cuda.device_count())])
if not devices:
    raise SystemExit("frame_parallel_animation: no CUDA card")
job = AnimationJob(
    path=default_paths()[0],           # "Gargantua Fly-By"
    renderer=renderer,
    fps=24,
    duration=5.0 if not SMOKE else 0.25,
    out_path="flyby_720p.mp4",         # segments + concat when ffmpeg exists
)
stats = job.run(devices=devices)       # frame k -> device k % N
print(stats)
