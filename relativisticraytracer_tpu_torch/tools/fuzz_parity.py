"""Randomized parity fuzz: the kernel frame programs against the plain
march on the same device, across random poses x times x spins (port of
tools/tpu_fuzz_parity.py).

    python -m relativisticraytracer_tpu_torch.tools.fuzz_parity [--cases 24] [--seed 7]
        [--width 96 --height 64 --max-steps 400 --max-lsb 1] [--device cuda]

Each case draws a spin in (0.0, 0.9), a pose around the hole and a time
from `np.random.default_rng(seed)` in the JAX tool's order, so case k here
is case k of that tool's report. It renders the frame through a
`loop="pallas"` renderer (the kernels on a CUDA device, their plain
versions on the CPU) and a `loop="while"` renderer (the plain march), both
on `--device`, with a `procedural_starfield(128, 256)` sky and the default
effects, and prints the JAX tool's line for the case.

The gate. The JAX tool allows 1 LSB, one compiler on both sides. Here the
kernels' ray generation and the plain march's differ by an ulp here and
there, which flips a few hit-mask pixels (tests/test_compact.py:156-158),
so a case passes when its RMSE is under 1e-3 (the frame gate of
bench.py:84-89) and fewer than 1e-3 of its pixels are off by more than
`--max-lsb` in a channel. The report keeps the JAX tool's keys (`max_lsb`,
`mismatch_frac` a case; `worst_lsb`, `pass`) beside the gate's, goes to
chiprun_out/fuzz_parity.json, and the run exits 1 when a case fails.
`run` is the function entry; it also takes the inline program.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time as _time
from typing import Callable, Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from relativisticraytracer_tpu_torch.config import CameraEffects, RenderSettings, SceneConfig
from relativisticraytracer_tpu_torch.render.camera import camera_state_from_pose
from relativisticraytracer_tpu_torch.render.pipeline import Renderer
from relativisticraytracer_tpu_torch.render.skybox import procedural_starfield, skybox_from_array

SPINS = (0.0, 0.9)
RMSE_GATE = 1e-3   # bench.py:84-89
FRAC_GATE = 1e-3   # pixels off by more than max_lsb
OUT = pathlib.Path(__file__).resolve().parents[2] / "chiprun_out"


def poses(cases: int, seed: int) -> Iterator[Tuple[float, Tuple[float, float, float],
                                                   float, float, float]]:
    """(spin, pos, yaw, pitch, time) of each case, drawn as the JAX tool
    draws them: radius 25..70, any azimuth, heights crossing the disk
    plane, the look jittered around the centre."""
    rng = np.random.default_rng(seed)
    for _ in range(cases):
        spin = float(rng.choice([0.0, 0.9]))
        r = float(rng.uniform(25.0, 70.0))
        az = float(rng.uniform(0.0, 2 * np.pi))
        y = float(rng.uniform(-15.0, 15.0))
        pos = (float(r * np.sin(az)), y, float(-r * np.cos(az)))
        yaw = float(np.degrees(az) + rng.uniform(-25.0, 25.0))
        pitch = float(np.degrees(np.arctan2(-y, r)) + rng.uniform(-8.0, 8.0))
        t = float(rng.uniform(0.0, 30.0))
        yield spin, pos, yaw, pitch, t


def compare(got: np.ndarray, want: np.ndarray, max_lsb: int) -> Dict:
    """The case's numbers: the JAX tool's `max_lsb` and `mismatch_frac`
    (over every uint8 of the frame), the RGB RMSE, and the share of pixels
    off by more than `max_lsb` in a channel."""
    d = np.abs(got.astype(np.int64) - want.astype(np.int64))
    rmse = float(np.sqrt(np.mean((d[..., :3] / 255.0) ** 2)))
    over = float(np.mean((d > max_lsb).any(axis=-1)))
    return dict(max_lsb=int(d.max()), mismatch_frac=float(np.mean(got != want)),
                rmse=rmse, over_lsb_frac=over,
                ok=bool(rmse < RMSE_GATE and over < FRAC_GATE))


def run(cases: int = 24, seed: int = 7, width: int = 96, height: int = 64,
        max_steps: int = 400, max_lsb: int = 1, media_pass: str = "compact",
        device="cuda", plain_frames: Optional[Dict[int, np.ndarray]] = None,
        log: Optional[Callable[[str], None]] = print) -> Dict:
    """The fuzz for one kernel program (`media_pass`) on `device`; returns
    the report. `plain_frames` holds the "while" renderer's frame of each
    case; pass the same dict to a run at the same arguments for the other
    program and they are rendered once. The report's `plain_seconds` holds
    the wall seconds of each plain frame this run rendered (each ends in
    its copy to the host)."""
    device = torch.device(device)
    sky = skybox_from_array(procedural_starfield(128, 256, device=device), device)
    renderers = {}
    for spin in SPINS:
        scene = SceneConfig(spin_a=spin, max_steps=max_steps)
        for loop in ("pallas", "while"):
            settings = RenderSettings(width=width, height=height, loop=loop,
                                      media_pass=media_pass)
            renderers[(spin, loop)] = Renderer(scene, settings, skybox=sky, device=device)
    if plain_frames is None:
        plain_frames = {}

    report = {"platform": device.type, "device": str(device), "media_pass": media_pass,
              "cases": [], "max_lsb_budget": max_lsb, "rmse_gate": RMSE_GATE,
              "over_lsb_frac_gate": FRAC_GATE}
    t0 = _time.perf_counter()
    plain_seconds = []
    for k, (spin, pos, yaw, pitch, t) in enumerate(poses(cases, seed)):
        cam = camera_state_from_pose(pos, yaw, pitch)
        effects = CameraEffects()
        got = renderers[(spin, "pallas")].render_np(cam, effects, t)
        if k not in plain_frames:
            t1 = _time.perf_counter()
            plain_frames[k] = renderers[(spin, "while")].render_np(cam, effects, t)
            plain_seconds.append(_time.perf_counter() - t1)
        c = compare(got, plain_frames[k], max_lsb)
        report["cases"].append({
            "spin": spin, "pos": [round(p, 2) for p in pos],
            "yaw": round(yaw, 1), "pitch": round(pitch, 1), "time": round(t, 2), **c})
        if log:
            log(f"case {k:2d}: spin={spin} max_lsb={c['max_lsb']} "
                f"mismatch_frac={c['mismatch_frac']:.5f} rmse={c['rmse']:.3g} "
                f"over_lsb_frac={c['over_lsb_frac']:.5f}")
    rows = report["cases"]
    report.update(
        worst_lsb=max((c["max_lsb"] for c in rows), default=0),
        worst_rmse=max((c["rmse"] for c in rows), default=0.0),
        worst_mismatch_frac=max((c["mismatch_frac"] for c in rows), default=0.0),
        worst_over_lsb_frac=max((c["over_lsb_frac"] for c in rows), default=0.0),
        seconds=_time.perf_counter() - t0, plain_seconds=plain_seconds,
        **{"pass": all(c["ok"] for c in rows)})
    return report


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(prog="relativisticraytracer_tpu_torch.tools.fuzz_parity",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--cases", type=int, default=24)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--width", type=int, default=96)
    ap.add_argument("--height", type=int, default=64)
    ap.add_argument("--max-steps", type=int, default=400)
    ap.add_argument("--max-lsb", type=int, default=1)
    ap.add_argument("--device", default="cuda",
                    help="torch device of both renderers (default cuda: the CUDA kernels "
                         "against the plain march; cpu runs their plain versions)")
    args = ap.parse_args(argv)
    report = run(args.cases, args.seed, args.width, args.height, args.max_steps,
                 args.max_lsb, device=args.device)
    OUT.mkdir(exist_ok=True)
    (OUT / "fuzz_parity.json").write_text(json.dumps(report, indent=2))
    print(json.dumps({"worst_lsb": report["worst_lsb"], "worst_rmse": report["worst_rmse"],
                      "pass": report["pass"], "cases": args.cases,
                      "platform": report["platform"]}))
    if not report["pass"]:
        sys.exit(1)
    return report


if __name__ == "__main__":
    main()
