#!/usr/bin/env python
"""Serve a live fly-camera preview at http://localhost:8000 (MJPEG over
HTTP; Pillow encodes the JPEGs). Equivalent CLI:
python -m relativisticraytracer_tpu_torch interactive.
Controls: click to capture the mouse; WASD/Space/Shift fly, R records,
P plays a path, B/V/L/C effects, ESC quits.

Renders on the CUDA card; RRT_DEVICE names another device.
RRT_EXAMPLE_SMOKE=1 starts the server on an ephemeral port, fetches one
rendered frame over HTTP, then shuts down — so CI executes the real
preview path end-to-end."""

import os

from relativisticraytracer_tpu_torch import RenderSettings, SceneConfig
from relativisticraytracer_tpu_torch.io.image import load_skybox
from relativisticraytracer_tpu_torch.render.pipeline import Renderer
from relativisticraytracer_tpu_torch.runtime.app import Session
from relativisticraytracer_tpu_torch.runtime.preview import PreviewServer

SMOKE = os.environ.get("RRT_EXAMPLE_SMOKE") == "1"
DEVICE = os.environ.get("RRT_DEVICE", "cuda")

session = Session(renderer=Renderer(
    SceneConfig(**({"max_steps": 16} if SMOKE else {})),
    RenderSettings(width=960, height=540)
    if not SMOKE
    else RenderSettings(width=64, height=48, max_steps=16),
    skybox_rgba=load_skybox(
        None, fallback_shape=(1024, 2048) if not SMOKE else (32, 64), device=DEVICE
    ),
    device=DEVICE,
))
server = PreviewServer(session, port=8000 if not SMOKE else 0, fps_cap=30.0)
print(f"open http://localhost:{server.port} — click to capture the mouse; "
      "WASD/Space/Shift fly, R records, P plays a path, B/V/L/C effects, "
      "ESC quits")
if SMOKE:
    import urllib.request

    server.start()
    with urllib.request.urlopen(
        f"http://127.0.0.1:{server.port}/frame.jpg", timeout=120
    ) as r:
        assert r.status == 200 and r.read(2) == b"\xff\xd8", "not a JPEG"
    session.handle_key("escape")   # exercise the ESC path
    server.stop()
    print("smoke: one frame served, ESC shutdown clean")
else:
    server.serve_until_interrupt()
