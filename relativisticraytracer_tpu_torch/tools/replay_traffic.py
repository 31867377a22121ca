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

`march_pass` reads the replay's march pass alone on one frame, and the
report holds it for the headline still and for the Horizon Skimmer's
densest 1080p frame (t = 9 s; `MARCH_FRAMES`): each round's launch ms by
CUDA events, their sum and ps a step, the segment order's ms
(`with_segments`), the lane efficiency of the segment order (useful
lane-steps over 32 x each warp's longest segment) beside that of the
per-ray mapping it replaced (thread t: slot t / m of the round's ray
t % m), and the kernel's registers and resident warps an SM.
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
# The frames `march_pass` reads: (name, path index or None for the
# headline pose, time); the benchmark's two cells
MARCH_FRAMES = (("headline", None, 1.0), ("Horizon Skimmer t 9", 2, 9.0))
HEADLINE_POSE = ((0.0, 10.0, -60.0), 0.0, -10.0)
# A sleep kernel's cycles (~10 ms on an H100) that hold the stream while
# the host enqueues the timed calls
HOLD_CYCLES = 20_000_000


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
    plan = pc.with_segments(pc.replay_plan(record.total, cap, rounds=rounds, lib=lib),
                            record.rec, max_steps, lib)
    m, m_r, s, s_r = plan.counts.tolist()
    row = dict(width=w, height=h, max_steps=max_steps, pixels=w * h, rays=m, steps=s,
               density=s / (w * h), capacity=cap, rounds=rounds,
               rounds_used=int((plan.rounds[:, 1] > 0).sum()), rays_past=m - m_r,
               steps_past=s - s_r)
    if timed:
        fit = pc.with_segments(pc.replay_plan(record.total, max(s, 1), rounds=1, lib=lib),
                               record.rec, max_steps, lib)
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


def _event_ms(fn, reps: int = 3) -> float:
    """Mean device ms of `fn` by CUDA events after one warm call, the
    stream held by a sleep kernel while the host enqueues."""
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(HOLD_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def issued_lane_steps(lengths: torch.Tensor) -> int:
    """Lane-steps issued for threads with these segment lengths in launch
    order, 32 consecutive threads a warp, each warp running for its
    longest segment."""
    pad = torch.zeros(-(-lengths.numel() // 32) * 32, dtype=torch.int64, device=lengths.device)
    pad[:lengths.numel()] = lengths
    return 32 * int(pad.reshape(-1, 32).amax(1).sum())


def per_ray_order(rec: torch.Tensor, plan: pc.ReplayPlan) -> pc.ReplayPlan:
    """`plan` with the per-ray mapping in place of its segment order: round
    r's entries are its rays' slots, slot-major (entry t: slot t / m of
    the round's ray t % m), the empty ones included (they march nothing)."""
    slots = rec.shape[0]
    lens = rec[:, 6].reshape(slots, -1).to(torch.int64)
    entries, counts = [], []
    for first, rays, base, _ in plan.rounds.tolist():
        pix = plan.order[first:first + rays].long()
        n = lens[:, pix]  # [slots, rays]
        start = plan.offsets[first:first + rays] - base + torch.cumsum(n, 0) - n
        packed = pix * slots + torch.arange(slots, device=pix.device)[:, None]
        entries.append(torch.stack([start.reshape(-1), packed.reshape(-1)], 1))
        counts.append(rays * slots)
    segments = torch.full_like(plan.segments, -1)
    flat = torch.cat(entries)
    segments[:flat.shape[0]] = flat.to(torch.int32)
    return plan._replace(segments=segments, segment_counts=torch.tensor(
        counts, dtype=torch.int64, device=segments.device))


def segment_lengths(rec: torch.Tensor, plan: pc.ReplayPlan) -> List[torch.Tensor]:
    """Each round's segment lengths in the order the march pass takes them
    (the plan's segment order)."""
    slots = rec.shape[0]
    lens = rec[:, 6].reshape(slots, -1).to(torch.int64)
    out, at = [], 0
    for count in plan.segment_counts.tolist():
        seg = plan.segments[at:at + count].long()
        at += count
        out.append(lens[seg[:, 1] % slots, seg[:, 1] // slots])
    return out


def march_lanes(rec: torch.Tensor, plan: pc.ReplayPlan) -> Dict:
    """The march pass's lane efficiency over the plan's rounds (useful
    lane-steps over issued): of its segment order, and of the per-ray
    mapping it replaced (`per_ray_order`); the segments, the longest and
    the median length."""
    new = segment_lengths(rec, plan)
    old = segment_lengths(rec, per_ray_order(rec, plan))
    useful = sum(int(x.sum()) for x in new)
    segs = torch.cat(new)
    return dict(lane_efficiency=useful / max(sum(map(issued_lane_steps, new)), 1),
                lane_efficiency_per_ray=useful / max(sum(map(issued_lane_steps, old)), 1),
                segments=segs.numel(), longest_segment=int(segs.max()) if segs.numel() else 0,
                median_segment=float(segs.float().median()) if segs.numel() else 0.0)


def march_pass(scene: SceneConfig, settings: RenderSettings, time: float, pose, lib=None,
               reps: int = 3) -> Dict:
    """The replay's march pass on one frame at `pose` and `time` on the
    card: the record, the plan at the frame's capacity with its segment
    order, then each round's march launch (`reps` timed calls, CUDA
    events): round ms, their sum (`march_ms`), steps and ps a step, the
    segment order's ms, `march_lanes`, and the kernel's registers, shared
    bytes and resident warps an SM."""
    lib = cuda_lib.resolve(lib)
    dev = torch.device("cuda", torch.cuda.current_device())
    w, h = settings.width * settings.supersample, settings.height * settings.supersample
    max_steps = settings.resolved_max_steps(scene)
    record = pc.march_pallas_camera_sky_record(
        scene, camera_state_from_pose(*pose), CameraEffects(), time, w, h, max_steps,
        *SKY_SHAPE, slots=settings.media_slots, device=dev, lib=lib)
    cap = pc.step_capacity(w * h, max_steps)
    plan = pc.replay_plan(record.total, cap, rounds=pc.replay_rounds(w * h, max_steps, cap),
                          lib=lib)
    segments_ms = _event_ms(lambda: pc.with_segments(plan, record.rec, max_steps, lib), reps)
    plan = pc.with_segments(plan, record.rec, max_steps, lib)
    consts, stream = cuda_lib.scene_consts(scene), cuda_lib.current_stream(dev)
    pos, vel, _ = pc.step_list(plan.capacity, dev)
    rows = plan.rounds.tolist()
    round_ms = [_event_ms(lambda r=r: lib.replay_march(consts, record.rec, plan, r, pos, vel,
                                                       stream), reps)
                for r in range(len(rows)) if rows[r][1]]
    steps = sum(r[3] for r in rows)
    out = dict(width=w, height=h, time=time, steps=steps, rounds_used=len(round_ms),
               round_ms=round_ms, march_ms=sum(round_ms),
               ps_per_step=sum(round_ms) * 1e9 / steps if steps else 0.0,
               segments_ms=segments_ms, **march_lanes(record.rec, plan),
               **lib.replay_march_attrs(dev))
    del pos, vel
    torch.cuda.empty_cache()
    return out


def march_frames(lib=None, reps: int = 3) -> Dict[str, Dict]:
    """`march_pass` at 1920x1080 and the default scene and settings for
    each of MARCH_FRAMES."""
    paths, out = default_paths(), {}
    for name, path, t in MARCH_FRAMES:
        pose = HEADLINE_POSE if path is None else interpolate_path(paths[path], t)
        out[name] = march_pass(SceneConfig(), RenderSettings(width=1920, height=1080), t, pose,
                               lib, reps)
    return out


def march_line(name: str, row: Dict) -> str:
    """One report line of a `march_pass` row."""
    return (f"march pass, {name} {row['width']}x{row['height']} t {row['time']:g}: "
            f"{row['march_ms']:.4f} ms over {row['rounds_used']} rounds "
            f"{[round(x, 4) for x in row['round_ms']]}, {row['steps']} steps, "
            f"{row['ps_per_step']:.2f} ps a step; segment order {row['segments_ms']:.4f} ms; "
            f"lane efficiency {row['lane_efficiency']:.4f} (the per-ray mapping "
            f"{row['lane_efficiency_per_ray']:.4f}); {row['segments']} segments, longest "
            f"{row['longest_segment']}, median {row['median_segment']:g}; {row['regs']} "
            f"registers, {row['local_bytes']} B local, {row['shared_bytes']} B shared a block of "
            f"{row['threads']}, {row['blocks_per_sm']} blocks = {row['warps_per_sm']} warps an SM")


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
    march = march_frames(lib)
    OUT.mkdir(exist_ok=True)
    report = dict(device=torch.cuda.get_device_name(0), every=args.every, rows=rows,
                  totals=totals(rows), march=march)
    (OUT / "replay_traffic.json").write_text(json.dumps(report, indent=1))
    for line in summary(rows):
        print(line, flush=True)
    for name, row in march.items():
        print(march_line(name, row), flush=True)
    print(json.dumps(report["totals"]), flush=True)
    if not all(r["bitwise"] for r in rows):
        raise SystemExit("replay_traffic: a replay past the step list differs")


if __name__ == "__main__":
    main()
