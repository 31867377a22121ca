"""The compact frame's replay stage on the card, for an A/B between two
checkouts of the package in one session.

    python relativisticraytracer_tpu_torch/tools/replay_stage.py [--root DIR] [--reps N]

Imports `relativisticraytracer_tpu_torch` from `--root` (default: the
checkout that holds this file), records the headline frame (SceneConfig(),
1920x1080, 2000 steps, pose (0, 10, -60) yaw 0 pitch -10, t = 1, sky
addressing of a 2048x4096 starfield) and times its replay stage as the
frame runs it: `media_replay_sorted` at the frame's step-list capacity
(`step_capacity`), which builds the plan on the device, allocates the step
list and (I, T) and launches the replay's kernels; and its two parts,
the plan alone (`replay_plan`) and the kernels on a built plan
(`_replay`). Device ms by CUDA events, the stream held by a sleep kernel
while the host enqueues, so the host's pace does not enter; `--reps` turns
of 5 calls each. Prints one JSON line with the root, the card's name and
power limit, each turn's ms a call, and a digest of the (I, T) bytes,
which two checkouts that replay alike share.
Run the two checkouts in turns (A, B, B, A) in one session: the host and
the card move a frame by 1-2 ms from one machine to the next.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import pathlib
import subprocess
import sys

HEADLINE_POSE = ((0.0, 10.0, -60.0), 0.0, -10.0)
SKY_SHAPE = (2048, 4096)
HOLD_CYCLES = 20_000_000  # a sleep kernel of ~10 ms on an H100


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", default=str(pathlib.Path(__file__).resolve().parents[2]),
                        help="checkout whose package to import (default: this one)")
    parser.add_argument("--reps", type=int, default=5, help="timed turns (default 5)")
    args = parser.parse_args(argv)
    root = pathlib.Path(args.root).resolve()
    sys.path.insert(0, str(root))

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("replay_stage: no CUDA device")
    from relativisticraytracer_tpu_torch.config import CameraEffects, SceneConfig
    from relativisticraytracer_tpu_torch.ops import cuda_lib
    from relativisticraytracer_tpu_torch.ops import pallas_compact as pc
    from relativisticraytracer_tpu_torch.render.camera import camera_state_from_pose

    import relativisticraytracer_tpu_torch as pkg

    if pathlib.Path(pkg.__file__).resolve().parents[1] != root:
        raise SystemExit(f"replay_stage: imported {pkg.__file__}, not from {root}")
    dev = torch.device("cuda:0")
    lib = cuda_lib.kernels()
    scene = SceneConfig()
    w, h, steps = 1920, 1080, scene.max_steps
    scal = pc.pack_camera_scalars(camera_state_from_pose(*HEADLINE_POSE), CameraEffects(), 1.0)
    record = pc._record_cuda(scene, scal, w, h, steps, pc.SLOTS, *SKY_SHAPE, dev, lib)
    cap = pc.step_capacity(w * h, steps)

    plan = pc.replay_plan(record.total, cap)
    parts = {
        "stage": lambda: pc.media_replay_sorted(scene, record, 1.0, lib=lib, capacity=cap),
        "plan": lambda: pc.replay_plan(record.total, cap),
        "kernels": lambda: pc._replay(scene, record.rec, 1.0, plan, lib),
    }
    inten, trans = parts["stage"]()
    out = torch.stack([inten.x, inten.y, inten.z, trans]).cpu().numpy()
    turns = {name: [] for name in parts}
    for _ in range(args.reps):
        for name, fn in parts.items():
            fn()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(HOLD_CYCLES)
            start.record()
            for _ in range(5):
                fn()
            end.record()
            torch.cuda.synchronize()
            turns[name].append(start.elapsed_time(end) / 5)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(json.dumps(dict(root=str(root), device=torch.cuda.get_device_name(0), smi=smi,
                          capacity=cap, **{f"{k}_ms": v for k, v in turns.items()},
                          digest=hashlib.sha256(out.tobytes()).hexdigest()[:16])))


if __name__ == "__main__":
    main()
