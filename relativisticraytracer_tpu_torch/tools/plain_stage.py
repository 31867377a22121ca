"""The plain march (loop="while"/"scan") and the replay's plain twin on the
card, for an A/B between two checkouts of the package.

    python relativisticraytracer_tpu_torch/tools/plain_stage.py [--root DIR] [--count-headline]

Imports `relativisticraytracer_tpu_torch`, and `chip_smoke.StepCounter`,
from `--root` (default: the checkout that holds this file) and times on the
card, each on the host's clock around work that ends in a synchronize:

  fuzz      the fuzz tool's 24 plain frames (tools/fuzz_parity.poses(24, 7):
            96x64, 400 steps, loop="while", a procedural_starfield(128, 256)
            sky, the default effects), each frame;
  scan      fuzz case 0 as a loop="scan" frame;
  headline  one loop="while" frame of the headline (SceneConfig(),
            1920x1080, 2000 steps, pose (0, 10, -60) yaw 0 pitch -10, t = 1,
            a 2048x4096 starfield, the default effects, the settings'
            chunk 64);
  march     the headline's plain march as chip_smoke.py phase 5 runs it
            (ops/pallas_march._march_camera_sky_plain, the plain twin of
            march kernels 4-6, chunk 16) under the checkout's StepCounter:
            its ray-steps, disk-probe and cloud-probe steps;
  replay    the replay's plain twin (ops/pallas_compact._replay_plain) on
            the headline's plain record, every recorded ray, as phase 5
            runs it.

Then it counts the host syncs torch makes (its sync debug mode "warn") in
fuzz case 0's "while" and "scan" frames and, with --count-headline, in a
second, untimed headline frame (a checkout that syncs every step would
pay for its warnings in the timed one). Prints one JSON line: the root,
the card's name and power limit, the most memory torch's allocator held,
each time, the counts, and a digest of each output, which two checkouts that render alike share. Run the two
checkouts in turns (A, B, B, A) on one card, one after another.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import pathlib
import subprocess
import sys
import time
import warnings

HEADLINE_POSE = ((0.0, 10.0, -60.0), 0.0, -10.0)
SKY_SHAPE = (2048, 4096)
SYNC_WARNING = "called a synchronizing CUDA operation"


def digest(*arrays) -> str:
    h = hashlib.sha256()
    for a in arrays:
        h.update(a.detach().cpu().contiguous().numpy().tobytes() if hasattr(a, "detach")
                 else a.tobytes())
    return h.hexdigest()[:16]


def timed(fn):
    """(fn's result, its wall seconds), the card synchronized around it."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def counted_syncs(fn) -> int:
    """The host syncs torch makes in one call of `fn`."""
    import torch

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return sum(SYNC_WARNING in str(w.message) for w in caught)


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", default=str(pathlib.Path(__file__).resolve().parents[2]),
                        help="checkout whose package to import (default: this one)")
    parser.add_argument("--count-headline", action="store_true",
                        help="also count the host syncs of one more headline frame")
    args = parser.parse_args(argv)
    root = pathlib.Path(args.root).resolve()
    sys.path.insert(0, str(root))

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("plain_stage: no CUDA device")
    import chip_smoke
    import relativisticraytracer_tpu_torch as pkg
    from relativisticraytracer_tpu_torch.config import CameraEffects, RenderSettings, SceneConfig
    from relativisticraytracer_tpu_torch.ops import pallas_compact as pc
    from relativisticraytracer_tpu_torch.ops import pallas_march as pm
    from relativisticraytracer_tpu_torch.render.camera import camera_state_from_pose
    from relativisticraytracer_tpu_torch.render.pipeline import Renderer
    from relativisticraytracer_tpu_torch.render.skybox import (
        procedural_starfield,
        skybox_from_array,
    )
    from relativisticraytracer_tpu_torch.tools import fuzz_parity

    for mod in (pkg, chip_smoke):
        if pathlib.Path(mod.__file__).resolve().parents[1 if mod is pkg else 0] != root:
            raise SystemExit(f"plain_stage: imported {mod.__file__}, not from {root}")
    dev = torch.device("cuda:0")
    eff = CameraEffects()
    out = {}

    # the fuzz's plain frames and case 0 as a scan frame
    sky = skybox_from_array(procedural_starfield(128, 256, device=dev), dev)
    small = dict(width=96, height=64)
    renderers = {(spin, loop): Renderer(SceneConfig(spin_a=spin, max_steps=400),
                                        RenderSettings(loop=loop, **small), skybox=sky,
                                        device=dev)
                 for spin in fuzz_parity.SPINS for loop in ("while", "scan")}
    frames, seconds, case0 = [], [], None
    for spin, pos, yaw, pitch, t in fuzz_parity.poses(24, 7):
        cam = camera_state_from_pose(pos, yaw, pitch)
        frame, s = timed(lambda: renderers[(spin, "while")].render_np(cam, eff, t))
        frames.append(frame)
        seconds.append(s)
        case0 = case0 or (spin, cam, t)
    spin, cam, t = case0
    scan, out["scan_s"] = timed(lambda: renderers[(spin, "scan")].render_np(cam, eff, t))
    out.update(fuzz_s=seconds, fuzz_total_s=sum(seconds), fuzz_digest=digest(*frames),
               scan_digest=digest(scan), scan_bitwise_while=bool((scan == frames[0]).all()),
               syncs_fuzz0_while=counted_syncs(
                   lambda: renderers[(spin, "while")].render(cam, eff, t)),
               syncs_fuzz0_scan=counted_syncs(
                   lambda: renderers[(spin, "scan")].render(cam, eff, t)))
    torch.cuda.synchronize()

    # the headline: a loop="while" frame, the plain march, the plain replay
    scene = SceneConfig()
    hw, hh = 1920, 1080
    hcam = camera_state_from_pose(*HEADLINE_POSE)
    head_sky = skybox_from_array(procedural_starfield(*SKY_SHAPE, device=dev), dev)
    plain = Renderer(scene, RenderSettings(width=hw, height=hh, loop="while"),
                     skybox=head_sky, device=dev)
    frame, out["headline_s"] = timed(lambda: plain.render_np(hcam, eff, 1.0))
    out["headline_digest"] = digest(frame)
    if args.count_headline:
        out["syncs_headline_while"] = counted_syncs(lambda: plain.render(hcam, eff, 1.0))
        torch.cuda.synchronize()
    hscal = pc.pack_camera_scalars(hcam, eff, 1.0)
    with chip_smoke.StepCounter(dev) as counter:
        march, out["march_s"] = timed(lambda: pm._march_camera_sky_plain(
            scene, hscal, hw, hh, scene.max_steps, *SKY_SHAPE, dev))
    out["march_counts"] = counter.counts()
    out["march_digest"] = digest(*march[0], *march[1:])
    rec, out["record_s"] = timed(lambda: pc._record_plain(
        scene, hscal, hw, hh, scene.max_steps, pc.SLOTS, *SKY_SHAPE, dev))
    order = pc.replay_order(rec.total).long()
    (inten, trans), out["replay_s"] = timed(lambda: pc._replay_plain(scene, rec.rec, 1.0, order))
    out["replay_rays"] = int(order.numel())
    out["replay_digest"] = digest(inten, trans)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(json.dumps(dict(root=str(root), device=torch.cuda.get_device_name(0), smi=smi,
                          peak_reserved_mib=torch.cuda.max_memory_reserved() / 2**20, **out)),
          flush=True)


if __name__ == "__main__":
    main()
