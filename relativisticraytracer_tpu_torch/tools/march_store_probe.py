"""The replay march pass's store path on the card: the kernel as built, and
variants of its store path built from patched copies of csrc/.

    python -m relativisticraytracer_tpu_torch.tools.march_store_probe [--reps N]

csrc/replay.cu's replay_march_kernel stages a warp's steps in shared
memory and writes them out as runs of the step list aligned to 8 entries.
Each variant replaces that loop (the text from its "stage slot" comment to
the kernel's end) and is built as its own library
(ops/cuda_lib.KernelLibrary with `CSRC` pointed at the patched copy):
- `aligned`: the kernel as committed;
- `unaligned`: runs of 8 steps from each segment's own first step (the
  flush before the aligned one), so a run may start anywhere in a sector;
- `direct`: no stage, each step stored where it lands (16 + 8 bytes a lane);
- `nostore`: the steps marched and not stored (a lane's last state kept so
  the march stays), the pass's compute alone.
Each runs over the plan's segment order (longest first), and `aligned`
and `unaligned` also over the per-ray order it replaced (replay_traffic.per_ray_order:
thread t of a round of m rays takes slot t / m of ray t % m, the empty
slots included), so the sort's share and the store path's show apart.
At the headline frame (pose (0, 10, -60) yaw 0 pitch -10, t = 1) and the
Horizon Skimmer's densest 1080p frame (t = 9 s), SceneConfig(), 2000
steps: the plan and its segment order once, then every round's march
launch of each variant, timed by CUDA events (`--reps` calls after a
warm one, the stream held by a sleep kernel while the host enqueues, the
better of two turns), ms and ps a step, and a digest of the step lists
(every variant but `nostore` writes the same bytes). One JSON line a
frame, order and variant; the report also goes to
chiprun_out/march_store_probe.json.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import pathlib
import shutil
import subprocess
import tempfile
from typing import Dict, Optional, Sequence

import torch

from relativisticraytracer_tpu_torch.config import CameraEffects, SceneConfig
from relativisticraytracer_tpu_torch.ops import cuda_lib
from relativisticraytracer_tpu_torch.ops import pallas_compact as pc
from relativisticraytracer_tpu_torch.paths import default_paths, interpolate_path
from relativisticraytracer_tpu_torch.render.camera import camera_state_from_pose
from relativisticraytracer_tpu_torch.tools.replay_traffic import (
    HEADLINE_POSE,
    MARCH_FRAMES,
    per_ray_order,
)

OUT = pathlib.Path(__file__).resolve().parents[2] / "chiprun_out"
SKY_SHAPE = (2048, 4096)
HOLD_CYCLES = 20_000_000  # a sleep kernel of ~10 ms on an H100
# the march loop's first line in replay_march_kernel, and what follows it
BEGIN = "        // stage slot of step i"
END = "// The step's transmittance from its opacity"

_STEP = """                V3 rel = recenter(c, p);
                float r2 = rel.x * rel.x + rel.y * rel.y + rel.z * rel.z;
                bool zd, zc;
                media_zones(c, rel, r2, zd, zc);
                float h, h6;
                adaptive_h(c, r2, zd, zc, h, h6);
                rk4_step(c, p, v, h, h6);
"""
_CLOSE = """    }
}

"""
VARIANTS: Dict[str, Optional[str]] = {
    "aligned": None,
    "unaligned": """        const int warp_len = __reduce_max_sync(FULL, len);
        for (int base = 0; base < warp_len; base += STAGE) {
            for (int i = 0; i < STAGE && base + i < len; ++i) {
""" + _STEP + """                stage_pos[w][lane][i] = make_float4(rel.x, rel.y, rel.z, v.x);
                stage_vel[w][lane][i] = make_float2(v.y, v.z);
            }
            __syncwarp();
            for (int g = 0; g < 8; ++g) {
                const int src = g * 4 + (lane >> 3), i = lane & 7;
                const int src_len = __shfl_sync(FULL, len, src);
                const long long src_start = __shfl_sync(FULL, start, src);
                if (base + i < src_len) {
                    pos[src_start + base + i] = stage_pos[w][src][i];
                    vel[src_start + base + i] = stage_vel[w][src][i];
                }
            }
            __syncwarp();
        }
""" + _CLOSE,
    "direct": """        const int warp_len = __reduce_max_sync(FULL, len);
        for (int i = 0; i < warp_len; ++i) {
            if (i < len) {
""" + _STEP + """                pos[start + i] = make_float4(rel.x, rel.y, rel.z, v.x);
                vel[start + i] = make_float2(v.y, v.z);
            }
        }
""" + _CLOSE,
    "nostore": """        const int warp_len = __reduce_max_sync(FULL, len);
        for (int i = 0; i < warp_len; ++i) {
            if (i < len) {
""" + _STEP + """            }
        }
        if (len > 0) pos[start] = make_float4(p.x, p.y, p.z, v.x);
""" + _CLOSE,
}


def build(name: str, tmp: pathlib.Path) -> cuda_lib.KernelLibrary:
    """The kernel library with variant `name` of the march loop."""
    if VARIANTS[name] is None:
        return cuda_lib.kernels()
    text = (cuda_lib.CSRC / "replay.cu").read_text()
    src = tmp / name
    shutil.copytree(cuda_lib.CSRC, src)
    (src / "replay.cu").write_text(text[:text.index(BEGIN)] + VARIANTS[name]
                                   + text[text.index(END):])
    saved, cuda_lib.CSRC = cuda_lib.CSRC, src
    try:
        return cuda_lib.KernelLibrary()
    finally:
        cuda_lib.CSRC = saved


def _event_ms(fn, reps: int) -> float:
    best = float("inf")
    for _ in range(2):
        fn()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(HOLD_CYCLES)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end) / reps)
    return best


def probe(reps: int = 3, variants: Sequence[str] = tuple(VARIANTS)):
    """One row a frame of MARCH_FRAMES, order and variant (see the module
    doc)."""
    dev = torch.device("cuda:0")
    scene = SceneConfig()
    w, h, steps = 1920, 1080, scene.max_steps
    lib = cuda_lib.kernels()
    paths, rows = default_paths(), []
    with tempfile.TemporaryDirectory() as tmp:
        libs = {name: build(name, pathlib.Path(tmp)) for name in variants}
        for frame, path, t in MARCH_FRAMES:
            pose = HEADLINE_POSE if path is None else interpolate_path(paths[path], t)
            scal = pc.pack_camera_scalars(camera_state_from_pose(*pose), CameraEffects(), t)
            rec = pc._record_cuda(scene, scal, w, h, steps, pc.SLOTS, *SKY_SHAPE, dev, lib)
            cap = pc.step_capacity(w * h, steps)
            plan = pc.replay_plan(rec.total, cap, rounds=pc.replay_rounds(w * h, steps, cap),
                                  lib=lib)
            plan = pc.with_segments(plan, rec.rec, steps, lib)
            consts, stream = cuda_lib.scene_consts(scene), cuda_lib.current_stream(dev)
            pos, vel, _ = pc.step_list(cap, dev)
            table = plan.rounds.tolist()
            n_steps = sum(r[3] for r in table)
            runs = [("segment order", plan, name) for name in libs]
            runs += [("per-ray order", per_ray_order(rec.rec, plan), name)
                     for name in ("unaligned", "aligned") if name in libs]
            for order, oplan, name in runs:
                def march(vlib=libs[name], oplan=oplan):
                    for r in range(len(table)):
                        vlib.replay_march(consts, rec.rec, oplan, r, pos, vel, stream)

                ms = _event_ms(march, reps)
                digest = hashlib.sha256()
                march()
                for row in table:
                    if row[1]:
                        digest.update(pos[:row[3]].cpu().numpy().tobytes())
                        digest.update(vel[:row[3]].cpu().numpy().tobytes())
                rows.append(dict(frame=frame, order=order, variant=name, steps=n_steps, ms=ms,
                                 ps_per_step=ms * 1e9 / n_steps,
                                 digest=digest.hexdigest()[:16]))
                print(json.dumps(rows[-1]), flush=True)
            del pos, vel, rec, plan
            torch.cuda.empty_cache()
    return rows


def main(argv: Optional[Sequence[str]] = None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--reps", type=int, default=3, help="timed calls a turn (default 3)")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("march_store_probe: no CUDA device")
    rows = probe(args.reps)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    OUT.mkdir(exist_ok=True)
    (OUT / "march_store_probe.json").write_text(json.dumps(dict(smi=smi, rows=rows), indent=1))
    print(smi)
    stored = {r["digest"] for r in rows if r["variant"] != "nostore"}
    if len(stored) != len(MARCH_FRAMES):
        raise SystemExit("march_store_probe: the store variants wrote different step lists")


if __name__ == "__main__":
    main()
