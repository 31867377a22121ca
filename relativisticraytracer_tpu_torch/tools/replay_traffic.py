"""The replay's traffic along the default camera paths: how many steps the
compact frame's replay needs, in how many rounds of the step list, and how
much of it goes past them.

    python -m relativisticraytracer_tpu_torch.tools.replay_traffic [--every SECONDS]

For sampled times of each default path (paths.default_paths, every
`--every` seconds from 0 to the last keyframe) and each frame size (the
CLI's cinema, native and realtime presets), the record pass at the default
scene, settings and effects, then the replay plan built on the device
(ops/pallas_compact.replay_plan) read on the host: m rays with a replay, S
steps, the step density S / pixels, and at the step list's capacity
(pallas_compact.step_capacity) the rounds the frame launches and uses and
the rays and steps the rounds leave to the per-ray kernel. On a CUDA device
it also times the replay's kernels (CUDA events, on a plan built
beforehand) at that capacity and at one that holds every step in one round
(`replay_fit_ms`, the reference), so the cost of the rounds and of the rays
past them shows per frame, and holds the two replays' (I, T) bitwise equal.
The report goes to chiprun_out/replay_traffic.json; `summary` condenses it
to one line per path and size.
"""

from __future__ import annotations

import argparse
import json
import pathlib
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from relativisticraytracer_tpu_torch.config import CameraEffects, RenderSettings, SceneConfig
from relativisticraytracer_tpu_torch.ops import cuda_lib
from relativisticraytracer_tpu_torch.ops import pallas_compact as pc
from relativisticraytracer_tpu_torch.paths import default_paths, interpolate_path
from relativisticraytracer_tpu_torch.render.camera import camera_state_from_pose

# (name, width, height): the CLI's presets (__main__.PRESETS) the compact
# frame renders at
SIZES = (("cinema", 1920, 1080), ("native", 1000, 700), ("realtime", 480, 272))
# The record's sky addressing only: the replay does not depend on it.
SKY_SHAPE = (1024, 2048)
OUT = pathlib.Path(__file__).resolve().parents[2] / "chiprun_out"


def frame_traffic(scene: SceneConfig, settings: RenderSettings, time: float, pose,
                  device="cuda", lib=None, timed: bool = False) -> Dict:
    """One frame's replay traffic at `pose` = (pos, yaw, pitch) and `time`:
    pixels, m, S, the density, the capacity, the rounds launched and those
    with rays, the rays and steps the rounds leave to the per-ray kernel,
    and with `timed` (CUDA only) the replay's kernel ms at the capacity
    (`replay_ms`) and at a capacity of S in one round (`replay_fit_ms`),
    and whether the two replays agree bitwise (`bitwise`)."""
    w, h = settings.width * settings.supersample, settings.height * settings.supersample
    max_steps = settings.resolved_max_steps(scene)
    record = pc.march_pallas_camera_sky_record(
        scene, camera_state_from_pose(*pose), CameraEffects(), time, w, h, max_steps,
        *SKY_SHAPE, slots=settings.media_slots, device=device, lib=lib)
    cap = pc.step_capacity(w * h, max_steps)
    rounds = pc.replay_rounds(w * h, max_steps, cap)
    plan = pc.replay_plan(record.total, cap, rounds=rounds, lib=lib)
    m, m_r, s, s_r = plan.counts.tolist()
    row = dict(width=w, height=h, max_steps=max_steps, pixels=w * h, rays=m, steps=s,
               density=s / (w * h), capacity=cap, rounds=rounds,
               rounds_used=int((plan.rounds[:, 1] > 0).sum()), rays_past=m - m_r,
               steps_past=s - s_r)
    if timed:
        fit = pc.replay_plan(record.total, max(s, 1), rounds=1, lib=lib)
        got, row["replay_ms"] = _replay_ms(scene, record, time, plan, lib)
        want, row["replay_fit_ms"] = _replay_ms(scene, record, time, fit, lib)
        # the rays past the list replay to the same bits as in the list
        row["bitwise"] = bool(torch.equal(got, want))
        del got, want
        torch.cuda.empty_cache()  # a dense frame's list can be tens of GB
    return row


def _replay_ms(scene, record, time, plan, lib):
    """((I, T) stacked as [4, H, W], the device ms of the replay's kernels
    on a built plan: one warm call, then the better of two timed ones)."""
    def run():
        inten, trans = pc._replay(scene, record.rec, time, plan, lib)
        return torch.stack([inten.x, inten.y, inten.z, trans])

    out = run()
    best = float("inf")
    for _ in range(2):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        run()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end))
    return out, best


def path_times(duration: float, every: float) -> List[float]:
    """0, every, 2 every, ... up to and including `duration`."""
    return [float(t) for t in np.arange(0.0, duration + 1e-6, every)]


def survey(sizes: Sequence[Tuple[str, int, int]] = SIZES, every: float = 1.0,
           device="cuda", lib=None, scene: Optional[SceneConfig] = None,
           max_steps: Optional[int] = None, timed: Optional[bool] = None) -> List[Dict]:
    """frame_traffic for every default path, sampled time and size."""
    scene = scene or SceneConfig()
    timed = torch.device(device).type == "cuda" if timed is None else timed
    rows = []
    for path in default_paths():
        for t in path_times(path.keyframes[-1].time, every):
            pose = interpolate_path(path, t)
            for name, w, h in sizes:
                settings = RenderSettings(width=w, height=h, max_steps=max_steps)
                row = frame_traffic(scene, settings, t, pose, device, lib, timed)
                rows.append(dict(path=path.name, time=t, size=name, **row))
    return rows


# The step list's earlier size, 64 entries a pixel: the frames denser than
# it are those whose tail a list of that size sent to the per-ray kernel.
DENSE = 64


def summary(rows: Sequence[Dict]) -> List[str]:
    """One line per (path, size): frames, the step density (median, max),
    the frames in more than one round and those with rays left to the
    per-ray kernel, and what the frames denser than DENSE steps a pixel
    cost against one list that holds every step."""
    lines = []
    for key in dict.fromkeys((r["path"], r["size"]) for r in rows):
        sel = [r for r in rows if (r["path"], r["size"]) == key]
        dens = np.array([r["density"] for r in sel])
        multi = [r for r in sel if r["rounds_used"] > 1]
        past = [r for r in sel if r["rays_past"]]
        worst = max(sel, key=lambda r: r["steps"])
        line = (f"{key[0]} at {key[1]} {sel[0]['width']}x{sel[0]['height']}: {len(sel)} frames, "
                f"steps a pixel median {np.median(dens):.2f} max {dens.max():.2f} "
                f"(S max {worst['steps']} at t {worst['time']:g}, capacity "
                f"{sel[0]['capacity']}, {sel[0]['rounds']} rounds); frames in more than one "
                f"round {len(multi)} (rounds used up to {max(r['rounds_used'] for r in sel)}); "
                f"frames with rays left to the per-ray kernel {len(past)}")
        if past:
            line += (f" (rays up to {max(r['rays_past'] for r in past)}, steps up to "
                     f"{max(r['steps_past'] for r in past)})")
        if "replay_ms" in sel[0]:
            dense = [r for r in sel if r["density"] > DENSE]
            line += (f"; frames denser than {DENSE} steps a pixel {len(dense)}, replay ms summed "
                     f"{sum(r['replay_ms'] for r in dense):.3f} against one list's "
                     f"{sum(r['replay_fit_ms'] for r in dense):.3f}; replay ms max "
                     f"{max(r['replay_ms'] for r in sel):.3f}; bitwise the one list's "
                     f"{all(r['bitwise'] for r in sel)}")
        lines.append(line)
    return lines


def totals(rows: Sequence[Dict]) -> Dict[str, Dict]:
    """Per size: frames, those denser than DENSE steps a pixel, the rounds
    used at most, the frames with rays left to the per-ray kernel, and for
    the dense frames the replay ms summed against one list's."""
    out = {}
    for size in dict.fromkeys(r["size"] for r in rows):
        sel = [r for r in rows if r["size"] == size]
        dense = [r for r in sel if r["density"] > DENSE]
        out[size] = dict(frames=len(sel), dense=len(dense),
                         rounds_used=max(r["rounds_used"] for r in sel),
                         frames_past=sum(1 for r in sel if r["rays_past"]))
        if "replay_ms" in sel[0]:
            out[size].update(replay_ms=sum(r["replay_ms"] for r in dense),
                             replay_fit_ms=sum(r["replay_fit_ms"] for r in dense))
    return out


def main(argv: Optional[Sequence[str]] = None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--every", type=float, default=1.0,
                        help="seconds of path time between samples (default 1)")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("replay_traffic: no CUDA device")
    lib = cuda_lib.kernels()
    rows = survey(every=args.every, lib=lib)
    OUT.mkdir(exist_ok=True)
    report = dict(device=torch.cuda.get_device_name(0), every=args.every, rows=rows,
                  totals=totals(rows))
    (OUT / "replay_traffic.json").write_text(json.dumps(report, indent=1))
    for line in summary(rows):
        print(line, flush=True)
    print(json.dumps(report["totals"]), flush=True)
    if not all(r["bitwise"] for r in rows):
        raise SystemExit("replay_traffic: a replay past the step list differs")


if __name__ == "__main__":
    main()
