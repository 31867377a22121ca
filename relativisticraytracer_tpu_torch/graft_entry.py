"""Graft entry points of the port (counterpart of the repo root's
__graft_entry__.py, which drives the JAX package).

entry(device)          -> (fn, example_args): one forward render of the
                          flagship full scene through the kernel frame
                          program (record, replay and sky kernels).
dryrun_multichip(n)    -> the multi-device paths on n devices: a small
                          sharded frame, the 1920x1080 compact shard grid
                          and a frame-parallel animation job.

    python -m relativisticraytracer_tpu_torch.graft_entry [n]     # default 8

Both run on CUDA cards unless the caller passes other devices; with no
card and no devices given they raise. There is no CPU fallback.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from relativisticraytracer_tpu_torch.config import CameraEffects, RenderSettings, SceneConfig
from relativisticraytracer_tpu_torch.ops.pallas_compact import render_frame_pallas_compact
from relativisticraytracer_tpu_torch.render.camera import camera_state_from_pose
from relativisticraytracer_tpu_torch.render.skybox import procedural_starfield, skybox_from_array

POSE = ((0.0, 5.0, -38.0), 0.0, -6.0)


def entry(device="cuda"):
    """(fn, example_args): `fn(camera, effects, time, sky)` renders the
    full scene (disk + clouds + skybox + post FX) at 256x256 with a
    256-step budget on `device` -> uint8 [256, 256, 4]. It runs the
    compact frame program that Renderer dispatches; on the CPU its
    kernels are their plain PyTorch versions."""
    device = torch.device(device)
    scene = SceneConfig(max_steps=256)
    settings = RenderSettings(width=256, height=256, max_steps=256)

    def fn(camera, effects, time, sky):
        return render_frame_pallas_compact(scene, settings, camera, effects, time, sky,
                                           device=device)

    camera = camera_state_from_pose(*POSE)
    sky = skybox_from_array(procedural_starfield(128, 256, device=device), device)
    example_args = (camera, CameraEffects(), 1.0, sky)
    return fn, example_args


def shard_devices(n_devices: int, devices: Optional[Sequence] = None):
    """`n_devices` devices for the dry run: `devices` (default: every CUDA
    card) repeated in turn up to n_devices. Raises when there is none."""
    if devices is None:
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
        if not devices:
            raise RuntimeError(f"dryrun_multichip({n_devices}): no CUDA device; pass "
                               f"`devices` (e.g. ['cpu'] * {n_devices})")
    devices = [torch.device(d) for d in devices]
    if not devices:
        raise ValueError(f"dryrun_multichip({n_devices}): `devices` is empty")
    return [devices[k % len(devices)] for k in range(n_devices)]


def dryrun_multichip(n_devices: int, devices: Optional[Sequence] = None) -> dict:
    """The multi-device paths over `n_devices` devices (see shard_devices):
    one sharded frame on tiny shapes, the 1920x1080 compact shard grid at
    8 steps (strip-interleaved, reassembled on the host) and a 4-frame
    animation job dealt round-robin. Each stage checks its output's shape
    and dtype and prints one line. Returns the host frames ("frame",
    "frame_hd", the latter in image order) and the job's stats ("job")."""
    import tempfile

    from relativisticraytracer_tpu_torch.parallel.sharding import (
        make_mesh,
        make_sharded_renderer,
    )
    from relativisticraytracer_tpu_torch.paths import default_paths
    from relativisticraytracer_tpu_torch.render.pipeline import Renderer
    from relativisticraytracer_tpu_torch.runtime.app import AnimationJob

    devices = shard_devices(n_devices, devices)
    distinct = len(set(devices))
    served = f"{n_devices} shards on {distinct} distinct device(s)"
    mesh = make_mesh(devices)
    ny, nx = mesh.shape
    first = devices[0]

    scene = SceneConfig(max_steps=32)
    settings = RenderSettings(width=16 * nx, height=8 * ny, max_steps=32)
    fn = make_sharded_renderer(scene, settings, mesh)
    camera = camera_state_from_pose(*POSE)
    sky = skybox_from_array(procedural_starfield(16, 32, device=first), first)
    frame = fn.reassemble(fn(camera, CameraEffects(), 1.0, sky))
    assert frame.shape == (settings.height, settings.width, 4), frame.shape
    assert frame.dtype == np.uint8
    print(f"dryrun_multichip OK: {served}, mesh {ny}x{nx}, frame {frame.shape}")

    # The production shape: the 1920x1080 headline frame through the
    # compact per-shard program on this mesh. Partitioning edge cases are
    # shape-driven, not step-driven, so 8 steps keep a CPU run short.
    # interleave="auto" resolves to strip-interleaved shards here, so the
    # shipped assignment and its host reassembly are what this checks.
    scene_hd = SceneConfig(max_steps=8)
    settings_hd = RenderSettings(width=1920, height=1080, max_steps=8)
    fn_hd = make_sharded_renderer(scene_hd, settings_hd, mesh, interleave="auto")
    sky_hd = skybox_from_array(procedural_starfield(64, 128, device=first), first)
    frame_hd = fn_hd.reassemble(fn_hd(camera, CameraEffects(), 1.0, sky_hd))
    assert frame_hd.shape == (1080, 1920, 4), frame_hd.shape
    assert frame_hd.dtype == np.uint8
    print(f"dryrun 1080p compact-shard OK: {served}, mesh {ny}x{nx}, shard "
          f"{1080 // ny}x{1920 // nx}, interleave auto, frame {frame_hd.shape}")

    # Frame-parallel animation across the same devices: each device
    # renders whole frames round-robin (no communication), the second
    # multi-device mode beside spatial tiling.
    renderer = Renderer(
        scene,
        RenderSettings(width=16, height=8, max_steps=16),
        skybox_rgba=procedural_starfield(16, 32, device=first),
        device=first,
    )
    with tempfile.TemporaryDirectory() as td:
        stats = AnimationJob(
            path=default_paths()[0], renderer=renderer, fps=2, duration=2.0,
            out_path=f"{td}/clip.rgba",
        ).run(devices=devices)
    assert stats["frames_written"] == 4, stats
    print(f"dryrun frame-parallel OK: {stats['frames_written']} frames round-robined over "
          f"{stats['devices']} device slots ({distinct} distinct device(s))")
    return {"frame": frame, "frame_hd": frame_hd, "job": stats}


if __name__ == "__main__":
    import sys

    dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 8)
