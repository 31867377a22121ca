#!/usr/bin/env python3
"""Drive the PyTorch port's frame paths, tools and host runtime on one CUDA card.

    python3 chip_smoke.py

Phases, one printed line (or block) each; any failure raises and the
script exits non-zero without the final result line:

  1. device: torch's device name and `nvidia-smi` name + power limit;
  2. build: nvcc builds csrc/*.cu (record, replay, sky, march), one process
     per source started together, for sm_90a; each kernel's ptxas line
     (the fused march kernels in their four (has_spin, has_mass_pos)
     instances), registers and resident warps an SM by the occupancy API,
     the march's launch geometry, and from `cuobjdump -sass` the march
     loop's instructions: those a vacuum step issues, its fp32 ones,
     branches and reads of the scene flags;
  3. kernels vs plain PyTorch on the card: record at 192x108 with 2000
     steps (hit mismatch < 1e-3, sky index equal where hit agrees), replay's
     three passes on that record (rtol 2e-6 / atol 5e-7; bitwise
     expected), forced step lists of 1 step (the per-ray kernel), a third
     of the steps (at least 3 rounds) and half (each bitwise the plain
     replay; each round's ms and the per-ray kernel's), sky on random and
     smooth directions with chromatic aberration on and off, with and
     without a mask, at n % 4 == 0 and != 0 (bitwise where unmasked), the
     three fused march kernels (march_sky, march_camera,
     march_planes) at 192x108 with 2000 steps (hit mismatch < 1e-3, (I, T)
     and v or the sky coordinates to rtol 2e-6 / atol 5e-7 where hits
     agree, sky indices equal), and the march's tile-key kernel (its
     launch-order key) within 1 of its plain twin;
  4. the seven golden cases through Renderer(device="cuda"), RMSE < 1e-3
     each against tests/goldens/*.npy (the two vacuum cases run the fused
     march kernel, the rest record/replay/sky), and a no-sky 192x108 frame
     (march_camera) against the plain path on the card, RMSE < 1e-3;
  5. the headline frame (1920x1080, full scene, 2000 steps, start pose,
     2048x4096 starfield): latency and pipelined throughput, per-kernel
     times beside the plain versions', the frame against the plain path on
     the card (RMSE < 1e-3), launches of each kernel on the main path,
     replayed rays and peak memory, the replay's device-side bookkeeping
     (replay_plan, its rounds kernel) and each replay pass's time in round
     0 (march, shade disk, shade cloud, composite), the empty rounds' time,
     the replay stage (plan, every round, the per-ray kernel) beside the
     same with its plan cut to one round, the step list's capacity and
     size, the per-ray kernel's no-op launch; forced step lists of 1 step,
     a third and half of the steps, bitwise the plain replay of every ray,
     each round's ms and the per-ray kernel's (at 1 step against its plain
     version on its rays); the headline pose at 3840x2160 and 7680x4320
     through the compact program (bitwise the inline frame; ms a frame, the
     step list's bytes, max_memory_allocated); then
     the same frame with media_pass="inline" (march_sky and the sky kernel
     without a mask: latency, throughput, RMSE against the compact frame), the no-sky frame (march_camera), march_planes on the
     headline rays, march_sky on the same frame with no medium (the same
     trajectories: the difference is the inline shading's cost), one plain
     march at 1080p (the plain time of the three
     march kernels, with its ray-step and per-ray step and probe counts,
     which size the bounds and give the SIMT efficiency of 16x2 and 8x4
     warp footprints and of ideal lane refill); and the replay's traffic
     on the three default paths, each second, at the cinema, native and
     realtime sizes (tools/replay_traffic.py: steps a pixel, the rounds
     each frame uses, the rays left to the per-ray kernel, the replay ms
     against one list that holds every step, the two replays bitwise);
  6. the -fmad=false vs contracted-FMA build A/B on the headline frame
     (informational; a build or launch failure still fails the run);
  7. one headline frame and one inline headline frame under
     torch.profiler — device time per kernel, device busy time against the
     frame's wall time, host syncs (the compact frame must have no
     cudaStreamSynchronize, and an event recorded right after `render`
     returns must still be pending; the inline frame must fetch its sky
     through the sky kernel, with no torch gather) — and their Chrome
     traces in chiprun_out/{headline,inline}_trace.json;
  8. shards on one card: the 1080p frame on a 4x2 grid of cuda:0, shards
     run one after another — the compact branch (strip-interleaved) and
     the inline branch (march_planes) — each bitwise the single-device
     frame after `reassemble`, with each shard's ms; the compact grid's
     host syncs under torch.profiler (none) and each shard's record launch
     by CUDA events; inline, each shard's
     march_planes launch by CUDA events beside its ray-steps and bound,
     the inline shards' sky through the sky kernel (8 launches, each
     tile's background bitwise sample_sky_fast, the kernel's summed ms and
     the coordinates + kernel path beside the torch gather path it
     replaced; the inline grid traced: no torch gather as a device kernel
     or host op), and one line from per-warp timelines (a measurement build,
     cuda_lib.kernels(timeline=True)) of the slowest shard's launch and of
     the full frame's: span, longest warp, the share of SM-time in the last
     20% with few warps resident, work per SM max over mean;
  9. the fused march's launch order against row-major, every tile by its
     key and the true-cost order, on the 8 shard launches and the three
     full-frame kernels, in turns;
 10. the card's streaming rate (a 1 GiB device-to-device copy, the L2
     cleared before each), which gives the byte-bound rows (sky,
     take_along) a measured floor; the probe kernels (csrc/probes.cu) at
     the tools' own shapes:
     chain_kernel over the ceiling's 4 waves of blocks at 500 iterations
     against its torch loop (fma, mul and mul_bf16 bitwise, rsqrt and exp
     rtol 1e-5) and take_along_kernel bitwise torch.gather; then the two
     tools' own runs (tools/roofline, tools/sky_primitives; their launches
     are the table's): each op's measured rate beside the spec arithmetic
     at the card's max SM clock, the SASS class counts of a vacuum step,
     each frame kernel's measured floor (its steps' hand-counted
     operations at the measured fp32 rate) with the SASS diagnostic (the
     built loop's shortest iteration at the measured rates) beside its
     67e12 bound, take_along's device ms with the L2 cold, byte bound and
     torch.gather's ms;
 11. the host runtime at 1920x1080 (SceneConfig(), 2000 steps, the
     2048x4096 starfield, default_paths()[0], 24 fps): a 12-frame
     AnimationJob through the raw sink with the compact and the inline
     program (frames 0 and 11 bitwise Renderer.render_np; mean_frame_ms
     beside phase 5; host syncs and the device's idle share from a
     torch.profiler trace of 4 job frames, no cudaStreamSynchronize in
     either), and each compact job frame's replay steps and rays past
     the step list; the pinned D2H copy; the
     yuv420p transfer (file size, frame 0 within 1 level of a float64
     oracle); resume after an interruption at frame 5, devices
     ["cuda:0", "cuda:0"] (traced: no cudaStreamSynchronize) and a
     4-frame PNG sequence, each byte-identical;
     the Session at the realtime and native presets with their motion
     renderers (tick ms still, flying and recording); the terminal
     preview and PreviewServer's /frame.jpg (where Pillow imports); the
     CLI's paths, still --preset cinema and anim --preset realtime as
     subprocesses (wall time; no kernel build);
 12. the user surface: graft_entry.entry() (256x256, 256 steps; RMSE
     against the plain path on the card, launches, ms), dryrun_multichip(8)
     with the card repeated (the 1080p grid bitwise the untiled frame) and
     the six examples (relativisticraytracer_tpu_torch/examples/) as
     subprocesses with RRT_DEVICE=cuda: render_still, custom_scene and
     multi_chip at full size, render_animation 0.5 (12 frames at 720p),
     frame_parallel_animation and live_preview in smoke mode (wall time and
     exit code each; any non-zero exit fails);
 13. the `loop` choice: the fuzz tool (tools/fuzz_parity.py) at its
     defaults — 24 random poses x times x spins (0 and 0.9) at 96x64 and
     400 steps — for the compact program (record, replay, sky) and the
     inline program (march_sky, sky) against loop="while" (the plain
     march) on the card, each case at RMSE < 1e-3 with fewer than 1e-3 of
     its pixels off by more than 1 LSB and every case bitwise, each
     program's kernels launched in its run, the plain frames' seconds; the
     plain march's host syncs: a loop="scan" frame of case 0 (bitwise its
     "while" frame, no host sync by torch's sync debug count) and two
     16-step frames under torch.profiler (scan: no cudaStreamSynchronize;
     while, chunk 4: at most 4 syncs); one loop="while" headline frame
     (1920x1080, 2000 steps, no kernel launched) bitwise the compact kernel
     frame, with both synchronized times and at most ceil(2000 / 64) = 32
     host syncs (torch's count); the CLI's still --loop while and --loop
     pallas (96x64, 64 steps) as subprocesses, within the fuzz's gate.

It then prints the kernel table as one JSON line (each kernel's launches
on its path, max error against its plain version, ms, plain ms, the bound
and what bounds it, and for the frame kernels the measured floor, what
sets it and the SASS diagnostic; the replay's row counts every round's
launches and gives the stage, the empty rounds and the 4K and 8K frames
beside its ms; the per-ray overflow kernel's ms is its launch at a step
list of 1 step, its main-path no-op launch and the half-capacity tail
through the rounds beside it), the
nvidia-smi line, and last {"ok": true, "device": {...}}. It needs one
CUDA card and imports no JAX.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import re
import subprocess
import tempfile
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent
GOLDEN_DIR = ROOT / "tests" / "goldens"
STARFIELD = ROOT / "tests" / "torch_data" / "starfield_64x128.npy"
HEADLINE = dict(width=1920, height=1080, pose=((0.0, 10.0, -60.0), 0.0, -10.0))

# (name, scene kwargs, effects on, (w, h), pose, time, max_steps):
# the golden cases of bench.py:49-65.
_POSE = ((0.0, 5.0, -38.0), 0.0, -6.0)
GOLDEN_CASES = [
    ("schwarzschild_vacuum", dict(enable_disk=False, enable_clouds=False), False,
     (64, 48), _POSE, 2.0, 400),
    ("kerr09_vacuum", dict(enable_disk=False, enable_clouds=False, spin_a=0.9), False,
     (64, 48), _POSE, 2.0, 400),
    ("disk_only", dict(enable_clouds=False), False, (64, 48), _POSE, 2.0, 400),
    ("full_scene_fx", dict(), True, (64, 48), _POSE, 2.0, 400),
    ("offaxis_full_192x108", dict(), True, (192, 108),
     ((-18.0, -5.0, -38.0), 18.0, 4.0), 7.0, 400),
    ("full_scene_512", dict(), True, (512, 512), _POSE, 2.0, 400),
    ("full_budget_192x108", dict(), True, (192, 108),
     ((0.0, 10.0, -60.0), 0.0, -10.0), 10.0, 2000),
]

from relativisticraytracer_tpu_torch.tools.roofline import (  # noqa: E402
    CLOUD_OPS,
    DISK_OPS,
    VAC_OPS,
)

CSRC = "relativisticraytracer_tpu_torch/csrc/"
# name: (source, the TPU kernel it replaces, its __global__ symbols)
KERNELS = {
    "record": (CSRC + "record.cu", "relativisticraytracer_tpu/ops/pallas_compact.py:332",
               ("record_kernel",)),
    "replay": (CSRC + "replay.cu", "relativisticraytracer_tpu/ops/pallas_compact.py:560",
               ("replay_rounds_kernel", "replay_march_kernel", "shade_disk_kernel",
                "shade_cloud_kernel", "replay_composite_kernel")),
    # the same TPU kernel's exact fallback (its image-layout replay under
    # lax.cond, pallas_compact.py:735-744): the rays the rounds of the step
    # list do not take
    "replay_overflow": (CSRC + "replay.cu", "relativisticraytracer_tpu/ops/pallas_compact.py:560",
                        ("replay_overflow_kernel",)),
    "sky": (CSRC + "sky.cu", "relativisticraytracer_tpu/ops/pallas_sky.py:189", ("sky_kernel",)),
    "march_sky": (CSRC + "march.cu", "relativisticraytracer_tpu/ops/pallas_march.py:543",
                  ("march_camera_sky_kernel",)),
    "march_camera": (CSRC + "march.cu", "relativisticraytracer_tpu/ops/pallas_march.py:416",
                     ("march_camera_kernel",)),
    "march_planes": (CSRC + "march.cu", "relativisticraytracer_tpu/ops/pallas_march.py:324",
                     ("march_planes_kernel",)),
    "chain": (CSRC + "probes.cu", "tools/vpu_roofline.py:97",
              ("chain_kernel", "chain_bf16_kernel")),
    "take_along": (CSRC + "probes.cu", "tools/bench_sky_primitives.py:95",
                   ("take_along_kernel",)),
}

# H100 SXM peaks (NVIDIA's data sheet): fp32 outside the tensor cores, HBM.
PEAK_F32 = 67e12
PEAK_BYTES = 3.35e12
def rmse(a: np.ndarray, b: np.ndarray) -> float:
    d = a[..., :3].astype(np.int64) - b[..., :3].astype(np.int64)
    return float(np.sqrt(np.mean((d / 255.0) ** 2)))


def sync_ms(fn, reps: int = 1):
    """(result of the last call, mean wall ms per call) with the card
    synchronized before and after."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1000.0 / reps


# A sleep kernel's cycles (~10 ms on an H100) that hold the stream while
# the host enqueues the calls event_ms times.
HOLD_CYCLES = 20_000_000


def event_ms(fn, reps: int = 5) -> float:
    """Mean device ms per call, by CUDA events, after one warm-up call.
    The stream waits on a sleep kernel while the host enqueues the calls,
    so the calls run back to back and a kernel shorter than its host-side
    launch is timed on the device, not at the host's pace."""
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(HOLD_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def round_ms(pc, lib, scene, rec, time, plan, dev):
    """Device ms (event_ms) of each round of the replay's passes on `plan`
    over one step list, in order, and of the per-ray kernel after them."""
    from relativisticraytracer_tpu_torch.ops import cuda_lib

    consts, stream = cuda_lib.scene_consts(scene), cuda_lib.current_stream(dev)
    pos, vel, emit = pc.step_list(plan.capacity, dev)
    inten = torch.zeros((3,) + tuple(rec.shape[2:]), device=dev)
    trans = torch.ones(tuple(rec.shape[2:]), device=dev)
    per_round = [event_ms(lambda r=r: pc.replay_round(lib, consts, scene, time, rec, plan, r, pos,
                                                      vel, emit, inten, trans, stream))
                 for r in range(plan.rounds.shape[0])]
    per_ray = event_ms(lambda: lib.replay_overflow(consts, float(time), rec, plan, inten, trans,
                                                   stream))
    return per_round, per_ray


def bound(ops: float, nbytes: float):
    """(bound_ms, bound_by): the larger of the operations at the fp32 peak
    and the bytes at the HBM rate."""
    t_ops, t_bytes = ops / PEAK_F32, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1000.0, ("operations" if t_ops >= t_bytes else "bytes")


class StepCounter:
    """Counts, on the card and without host syncs, what a plain march
    (render/march.march) does: ray-steps (rays active when a step starts),
    steps whose disk or cloud probe is True, and each ray's steps, disk-
    probe and cloud-probe steps (`per_ray` [3, rays], in pixel order). It
    wraps render/march's march_step, _media_contribution and _scatter
    (which march calls after every chunk of steps with the working set's
    pixel ids) while it is entered."""

    def __init__(self, device):
        self.n = torch.zeros(3, dtype=torch.int64, device=device)
        self.per_ray = None
        self._chunk = None  # [3, working set] counts since the last _scatter

    def __enter__(self):
        from relativisticraytracer_tpu_torch.render import march as rm

        self._rm = rm
        self._orig = step, media, scatter = rm.march_step, rm._media_contribution, rm._scatter

        def counted_step(scene, st, time, media_hook=None, **kw):
            self.n[0] += st.active.sum()
            if self._chunk is None:
                self._chunk = torch.zeros((3,) + tuple(st.active.shape), dtype=torch.int64,
                                          device=st.active.device)
            self._chunk[0] += st.active
            return step(scene, st, time, media_hook, **kw)

        def counted_scatter(full, ids, part):
            if self.per_ray is None:
                self.per_ray = torch.zeros((3,) + tuple(full.active.shape), dtype=torch.int64,
                                           device=full.active.device)
            self.per_ray.index_add_(1, ids, self._chunk)
            self._chunk = None
            return scatter(full, ids, part)

        def counted_media(*args, probe_disk=None, probe_cloud=None, **kw):
            for k, probe in ((1, probe_disk), (2, probe_cloud)):
                if probe is not None:
                    self.n[k] += probe.sum()
                    self._chunk[k] += probe
            return media(*args, probe_disk=probe_disk, probe_cloud=probe_cloud, **kw)

        rm.march_step, rm._media_contribution = counted_step, counted_media
        rm._scatter = counted_scatter
        return self

    def __exit__(self, *exc):
        self._rm.march_step, self._rm._media_contribution, self._rm._scatter = self._orig

    def counts(self):
        return [int(c) for c in self.n.tolist()]


def simt_efficiency(steps: np.ndarray, fw: int, fh: int) -> float:
    """sum(steps) / sum(32 * max over the warp) for warps that cover fw x fh
    pixel patches (fw * fh = 32; lanes past the image edge idle)."""
    h, w = steps.shape
    pad = np.zeros((-(-h // fh) * fh, -(-w // fw) * fw), np.int64)
    pad[:h, :w] = steps
    tiles = pad.reshape(pad.shape[0] // fh, fh, pad.shape[1] // fw, fw)
    return float(steps.sum() / (32.0 * tiles.max(axis=(1, 3)).sum()))


def refill_efficiency(steps: np.ndarray, lanes: int) -> float:
    """SIMT efficiency of ideal lane refill: `lanes` lanes (32 to a warp)
    take the rays in 16x2 patch order (h and w multiples of 2 and 16), each
    the next ray the moment its own ends; a warp issues until its last lane
    runs dry. sum(steps) / sum(32 * the warp's end)."""
    import heapq

    h, w = steps.shape
    patch = steps.reshape(h // 2, 2, w // 16, 16).transpose(0, 2, 1, 3).reshape(-1)
    free = [(0, lane) for lane in range(lanes)]
    end = np.zeros(lanes, np.int64)
    for s in patch.tolist():
        t, lane = heapq.heappop(free)
        end[lane] = t + s
        heapq.heappush(free, (t + s, lane))
    warp_end = end.reshape(-1, 32).max(axis=1)
    return float(steps.sum() / (32.0 * warp_end.sum()))


def timeline_summary(tl: np.ndarray, n_sms: int, full_warps: int) -> str:
    """One line from a march launch's per-warp timeline (rows of SM, start
    ns, end ns): its span; the share of SM-time in its last 20% with fewer
    than full/2 and full/4 warps resident; busy warp-time per SM, max over
    mean; how long the SMs took to go idle, from the first to the last;
    the longest warp's own time."""
    sm, start, end = tl[:, 0], tl[:, 1].astype(np.float64), tl[:, 2].astype(np.float64)
    t0, t1 = start.min(), end.max()
    taus = np.linspace(t0 + 0.8 * (t1 - t0), t1, 2000, endpoint=False)
    low = {full_warps // 2: 0, full_warps // 4: 0}
    busy, last = np.zeros(n_sms), np.full(n_sms, t0)
    for s in range(n_sms):
        m = sm == s
        if not m.any():
            for n in low:
                low[n] += len(taus)
            continue
        busy[s] = (end[m] - start[m]).sum()
        last[s] = end[m].max()
        resident = (np.searchsorted(np.sort(start[m]), taus, "right")
                    - np.searchsorted(np.sort(end[m]), taus, "right"))
        for n in low:
            low[n] += int((resident < n).sum())
    share = ", ".join(f"< {n} warps {c / (n_sms * len(taus)):.3f}" for n, c in low.items())
    used = int((np.bincount(sm.astype(np.int64), minlength=n_sms) > 0).sum())
    return (f"span {(t1 - t0) / 1e6:.3f} ms, {len(tl)} warps on {used} SMs, longest warp "
            f"{(end - start).max() / 1e6:.3f} ms; last 20%: SM-time with {share}; busy "
            f"warp-time per SM max/mean "
            f"{busy.max() / busy.mean():.3f}; SMs went idle over the last "
            f"{(last.max() - last.min()) / 1e6:.3f} ms")


def shard_launch_ms(lib, name: str, fn, hcam, eff, sky, reps: int):
    """Mean ms of each `name` launch ("record", "march_planes") of the
    sharded frame `fn`, in shard order, by CUDA events around the wrapper
    (the march's order-building step included) over `reps` frames."""
    launch, events = getattr(lib, name), []

    def timed(*args, **kwargs):
        ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
        ev[0].record()
        launch(*args, **kwargs)
        ev[1].record()
        events.append(ev)

    setattr(lib, name, timed)
    try:
        for _ in range(reps):
            fn(hcam, eff, 1.0, sky)
        torch.cuda.synchronize()
    finally:
        delattr(lib, name)
    per = np.array([a.elapsed_time(b) for a, b in events]).reshape(reps, -1)
    return per.mean(axis=0).tolist()


def march_shard(lib, scene, origin, direction, k, ny, nx, max_steps, dev):
    """march_planes on shard k (row-major over the ny x nx grid) of the
    frame's ray planes, as the inline shard renderer cuts them."""
    from relativisticraytracer_tpu_torch.ops import pallas_march as pm
    from relativisticraytracer_tpu_torch.core.vecmath import Vec3

    h, w = origin.x.shape
    i, j = divmod(k, nx)
    th, tw = h // ny, w // nx

    def cut(a):
        return a[i * th:(i + 1) * th, j * tw:(j + 1) * tw].contiguous()

    return pm._march_planes_cuda(scene, Vec3(*map(cut, origin)), Vec3(*map(cut, direction)),
                                 1.0, max_steps, lib)


def order_ab(lib, scene, hscal, ho, hd, head_sky, per_ray_all, steps_h, dev):
    """Phase 9: the fused march's launch order against others
    — row-major, every tile by its key (longest first), and the tiles by
    their true cost from the plain march's counts — on the 8 inline shard
    launches and the three full-frame kernels, in turns, each order's
    outputs bitwise the kept order's. It swaps lib.march_order, as phase 8
    swaps lib.march_planes."""
    from relativisticraytracer_tpu_torch.core.vecmath import Vec3
    from relativisticraytracer_tpu_torch.ops import cuda_lib
    from relativisticraytracer_tpu_torch.ops import pallas_march as pm

    hh, hw = per_ray_all.shape[1:]
    ny, nx = 4, 2
    sth, stw = hh // ny, hw // nx
    cost = (per_ray_all[0] * VAC_OPS + per_ray_all[1] * DISK_OPS
            + per_ray_all[2] * CLOUD_OPS) / VAC_OPS
    launches = []
    for k in range(ny * nx):
        i, j = divmod(k, nx)

        def cut(a, i=i, j=j):
            return a[i * sth:(i + 1) * sth, j * stw:(j + 1) * stw]

        launches.append((f"shard{k}", cut(cost), lambda o=Vec3(*(cut(a).contiguous() for a in ho)),
                         d=Vec3(*(cut(a).contiguous() for a in hd)):
                         pm._march_planes_cuda(scene, o, d, 1.0, steps_h, lib)))
    launches += [
        ("frame_sky", cost, lambda: pm._march_camera_sky_cuda(
            scene, hscal, hw, hh, steps_h, *head_sky.shape, dev, lib)),
        ("frame_camera", cost, lambda: pm._march_camera_cuda(scene, hscal, hw, hh, steps_h,
                                                             dev, lib)),
        ("frame_planes", cost, lambda: pm._march_planes_cuda(scene, ho, hd, 1.0, steps_h, lib)),
    ]

    def true_cost_order(c):
        h, w = c.shape
        x, y, inside = cuda_lib.tile_map(w, h)
        per = np.where(inside, c[np.minimum(y, h - 1), np.minimum(x, w - 1)], 0).max(axis=1)
        return torch.as_tensor(np.argsort(-per, kind="stable").astype(np.int32), device=dev)

    def flat(out):
        return torch.cat([t.reshape(-1).float() for t in list(out[0]) + [out[1]]])

    orders = {
        "kept (cost >= 1.5 x the cheapest first, then row-major)": None,
        "row-major": lambda consts, cam, rays, w, h, *rest: torch.arange(
            cuda_lib.tile_count(w, h), dtype=torch.int32, device=dev),
        "every tile by its key, longest first": lambda *a: torch.argsort(
            lib.tile_keys(*a), descending=True, stable=True).to(torch.int32),
        "true cost (plain march counts), longest first": "true",
    }
    ref = {name: flat(run()) for name, _, run in launches}
    res = {o: {} for o in orders}
    try:
        for rep in range(2):  # in turns: A B C D, A B C D
            for oname, rule in orders.items():
                for name, c, run in launches:
                    if rule == "true":
                        order = true_cost_order(c)
                        lib.march_order = lambda *a, order=order: order
                    elif rule is not None:
                        lib.march_order = rule
                    res[oname].setdefault(name, []).append(event_ms(run, reps=3))
                    if rep == 0 and not torch.equal(flat(run()), ref[name]):
                        raise AssertionError(f"order {oname} changed the {name} outputs")
                    lib.__dict__.pop("march_order", None)
    finally:
        lib.__dict__.pop("march_order", None)
    for oname, r in res.items():
        ms = {name: float(np.mean(v)) for name, v in r.items()}
        sh = [ms[f"shard{k}"] for k in range(ny * nx)]
        print(f"phase 9 order {oname}: shards {[round(x, 3) for x in sh]} ms (sum {sum(sh):.3f}, "
              f"max {max(sh):.3f}); full frame sky {ms['frame_sky']:.3f}, camera "
              f"{ms['frame_camera']:.3f}, planes {ms['frame_planes']:.3f} ms (mean of 2 turns); "
              f"outputs bitwise the kept order's", flush=True)


def device_busy(prof):
    """(busy ms — the union of the device intervals —, device span ms,
    device ms by kernel-table name, device events) of a finished
    torch.profiler run; busy None where it recorded no device events."""
    from torch.autograd import DeviceType

    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events() if e.device_type == DeviceType.CUDA)
    if not spans:
        return None, None, {}, 0
    busy_us, end_us = 0.0, spans[0][0]
    by_name = {}
    for s, e, name in spans:
        busy_us += max(0.0, e - max(s, end_us))
        end_us = max(end_us, e)
        symbol = re.sub(r"<.*>", "", name.split("(")[0]).split(" ")[-1]
        key = next((k for k, v in KERNELS.items() if symbol in v[2]), "other: " + name[:60])
        by_name[key] = by_name.get(key, 0.0) + (e - s) / 1000.0
    return busy_us / 1000.0, (end_us - spans[0][0]) / 1000.0, by_name, len(spans)


def host_syncs(prof, name: str = "cudaStreamSynchronize") -> int:
    return sum(1 for e in prof.events() if e.name == name)


# torch's host ops that gather by index (the profiler records host ops
# itself; device kernels come from CUPTI's activity records)
HOST_GATHERS = ("aten::index", "aten::index_select", "aten::gather", "aten::take",
                "aten::take_along_dim")


def torch_gathers_in(by_name: dict) -> list:
    """torch's gather kernels (advanced indexing, index_select, gather)
    among a trace's device kernels by name."""
    return [k for k in by_name
            if any(s in k.lower() for s in ("index_elementwise", "indexselect", "gather"))]


def trace_frame(render, label: str, lib=None):
    """One warm call of `render` under torch.profiler: (a summary line of
    device time by kernel and device busy time against wall time, the
    number of cudaStreamSynchronize calls, device ms by kernel-table name,
    whether an event recorded right after `render` returned was still
    pending, the host gather ops by name, and — with `lib` — its launch
    counts in the traced call), and writes its Chrome trace as
    <label>_trace.json in the output directory below."""
    from torch.profiler import ProfilerActivity, profile

    render()
    torch.cuda.synchronize()
    if lib is not None:
        lib.reset_launches()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        render()
        returned = torch.cuda.Event()
        returned.record()
        pending = not returned.query()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1000.0
    out = ROOT / "chiprun_out" / f"{label}_trace.json"
    out.parent.mkdir(exist_ok=True)
    prof.export_chrome_trace(str(out))
    launched = None if lib is None else dict(lib.launches)
    syncs = host_syncs(prof)
    gathers = {n: host_syncs(prof, n) for n in HOST_GATHERS if host_syncs(prof, n)}
    busy, span, by_name, n_events = device_busy(prof)
    if busy is None:
        return (f"phase 7 trace ({label}): frame wall {wall_ms:.3f} ms; the profiler recorded "
                f"no device events (device time not measured); cudaStreamSynchronize {syncs}; "
                f"device work pending when the call returned {pending}", syncs, by_name, pending,
                gathers, launched)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:14]
    return (f"phase 7 trace (torch.profiler, one {label} frame): wall {wall_ms:.3f} ms, "
            f"device busy {busy:.3f} ms (idle share "
            f"{1.0 - busy / wall_ms:.3f}), device span "
            f"{span:.3f} ms, {n_events} device events, "
            f"cudaStreamSynchronize {syncs}, cudaMalloc {host_syncs(prof, 'cudaMalloc')} (the "
            f"caching allocator's growth), device work pending when the call returned "
            f"{pending}; device ms by kernel: "
            + "; ".join(f"{k} {v:.3f}" for k, v in top)), syncs, by_name, pending, gathers, launched


def streaming_rate(dev, reps: int = 5) -> float:
    """The card's measured streaming rate, bytes/s: a 1 GiB device-to-
    device copy (1 GiB read + 1 GiB written) by CUDA events, the L2
    cleared (256 MiB written) before each; the best of `reps`."""
    n = 1 << 30
    src_buf = torch.empty(n, dtype=torch.uint8, device=dev).fill_(1)
    dst = torch.empty_like(src_buf)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    best = float("inf")
    for rep in range(reps + 1):  # the first is a warm-up
        flush.fill_(0)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        dst.copy_(src_buf)
        end.record()
        torch.cuda.synchronize()
        if rep:
            best = min(best, start.elapsed_time(end))
    del src_buf, dst, flush
    return 2.0 * n / (best / 1000.0)


def max_sm_mhz() -> float:
    """The card's maximum SM clock (nvidia-smi), MHz."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"], capture_output=True, text=True,
                         check=True, timeout=60).stdout
    return float(out.strip().splitlines()[0])


def phase10_probes(lib, dev, n_sms, counts, n_replay, replay_bytes, sky_bytes, overflow, tail):
    """Phase 10: the card's streaming rate, the probe kernels
    (csrc/probes.cu) against their plain twins at the tools' own shapes,
    then the two tools' own runs — their launches are this phase's count —
    with each op's measured rate beside the spec arithmetic, the SASS class
    counts of a vacuum step, each frame kernel's measured floor and SASS
    diagnostic, and take_along_kernel against torch.gather. `overflow` is
    (steps, disk-probe steps, cloud-probe steps, bytes) of the per-ray
    kernel's forced run, `tail` the same of the rays past the first round
    at half the steps. Returns (table rows of the two probes, {kernel:
    (floor ms, floor by, SASS ms)}, the tail's floor ms)."""
    from relativisticraytracer_tpu_torch.tools import roofline as rf
    from relativisticraytracer_tpu_torch.tools import sky_primitives as sp

    rate = streaming_rate(dev)
    print(f"phase 10 streaming rate: {rate / 1e12:.4f} TB/s (1 GiB device-to-device copy, "
          f"read + write, L2 cleared, best of 5; spec {PEAK_BYTES / 1e12:.2f})", flush=True)

    # kernel vs plain twin at the ceiling's shape, every op (these launches
    # are not counted); the fma pair is the table row's time
    tiles, iters = rf.ceiling_tiles(dev), rf.ITERS
    err_chain = 0.0
    for op in rf.OPS:
        x = rf.chain_input(op, dev)
        got = rf.chain(op, iters, x, tiles, lib)
        want, op_plain_ms = sync_ms(lambda: rf.chain_plain(op, iters, x, tiles))
        if op in ("fma", "mul", "mul_bf16"):
            if not torch.equal(got, want):
                raise AssertionError(f"chain_kernel {op} is not bitwise its plain twin")
        else:
            torch.testing.assert_close(got, want, rtol=1e-5, atol=0)
        err_chain = max(err_chain, (got - want).abs().max().item())
        if op == "fma":
            chain_ms = event_ms(lambda: rf.chain(op, iters, x, tiles, lib))
            chain_plain_ms = op_plain_ms
    for s in sp.SIZES:
        tab, idx = sp.inputs(s, sp.T, dev, seed=s)
        if not torch.equal(sp.take_along(tab, idx, lib), sp.take_along_plain(tab, idx)):
            raise AssertionError(f"take_along_kernel S={s} is not bitwise torch.gather")
    lane_fma = tiles * 1024 * rf.CHAINS * rf.INNER * iters
    chain_bound = bound(2 * lane_fma, 8 * 128 * 4 + tiles * 1024 * 4)  # an FMA is 2 flops
    print(f"phase 10 probes vs plain twins at {tiles} tiles x {iters} iterations: chain_kernel "
          f"(5 ops) max |d| {err_chain:.3g} (fma, mul, mul_bf16 bitwise; rsqrt, exp rtol 1e-5), "
          f"take_along_kernel bitwise torch.gather at S {list(sp.SIZES)}; chain fma: kernel "
          f"{chain_ms:.3f} ms, plain {chain_plain_ms:.1f} ms, bound {chain_bound[0]:.3f} ms",
          flush=True)

    # the tools' runs: the main path of this phase
    lib.reset_launches()
    n_steps, n_disk, n_cloud = counts
    out_dir = ROOT / "chiprun_out"
    report = rf.main(["--out", str(out_dir / "roofline.json")])
    sky = sp.main(["--out", str(out_dir / "sky_primitives.json")])
    launches = {k: lib.launches[k] for k in ("chain", "take_along")}
    if min(launches.values()) < 1:
        raise AssertionError(f"a probe kernel never launched in its tool's run: {launches}")
    mhz = max_sm_mhz()
    spec = {"fp32": n_sms * 128 * mhz * 1e6, "mufu": n_sms * 16 * mhz * 1e6}
    print(f"phase 10 measured rates (lane-ops/s; spec at the max SM clock {mhz:.0f} MHz: fp32 "
          f"{n_sms} SMs x 128 lanes = {spec['fp32']:.4g}, MUFU {n_sms} x 16 = "
          f"{spec['mufu']:.4g}; 67e12 counts an FMA as 2 flops): "
          + ", ".join(f"{op} {report[f'{op}_lane_ops_per_s']:.4g}" for op in rf.OPS)
          + f"; pipes {({k: float(f'{v:.4g}') for k, v in report['pipe_rates'].items()})}",
          flush=True)
    pipe_rates = report["pipe_rates"]
    shade = n_disk * DISK_OPS + n_cloud * CLOUD_OPS
    # the floor: the function's hand-counted operations at the measured
    # fp32 rate; beside it the SASS diagnostic (the shortest iteration of
    # the built loop, plus the same shading)
    floors = {}
    for name, sym in (("record", "record_kernel"), ("march_sky", "march_camera_sky_kernel"),
                      ("march_camera", "march_camera_kernel"),
                      ("march_planes", "march_planes_kernel")):
        k = report["kernels"][sym]
        media = (0, 0) if name == "record" else (n_disk, n_cloud)
        sass_ms = rf.kernel_floor_ms(k["shortest_classes"], pipe_rates, n_steps,
                                     0.0 if name == "record" else shade)[0]
        floors[name] = (rf.function_floor_ms(pipe_rates, n_steps, *media), "operations", sass_ms)
        print(f"  SASS {sym}: vacuum step {k['vacuum']} instructions {k['classes']}; shortest "
              f"iteration {k['shortest']} {k['shortest_classes']}")
    # the replay and its overflow kernel: their replayed steps and the
    # shading, or their bytes at the measured rate; sky: its bytes
    def ops_or_bytes(steps, disk, cloud, nbytes):
        f_ops = rf.function_floor_ms(pipe_rates, steps, disk, cloud)
        f_bytes = nbytes / rate * 1000.0
        return (f_ops, "operations", None) if f_ops >= f_bytes else (f_bytes, "bytes", None)

    floors["replay"] = ops_or_bytes(n_replay, n_disk, n_cloud, replay_bytes)
    floors["replay_overflow"] = ops_or_bytes(*overflow)
    tail_floor = ops_or_bytes(*tail)[0]
    floors["sky"] = (sky_bytes / rate * 1000.0, "bytes", None)
    for name, row in sky.items():
        if name.startswith("take_along") and not row["bitwise"]:
            raise AssertionError(f"{name}: the tool's kernel output is not torch.gather's")
    s64 = sky["take_along_S64"]
    print("phase 10 take_along_kernel (t 2040; device ms a call, the L2 cleared before each): "
          + "; ".join(f"S{s} {r['ms']:.4f} ms, bound {r['bound_ms']:.4f}, measured floor "
                      f"{r['bound_ms'] * PEAK_BYTES / rate:.4f}, torch.gather "
                      f"{r['gather_ms']:.4f}" for s, r in ((s, sky[f"take_along_S{s}"])
                                                           for s in sp.SIZES))
          + f"; launches {launches}", flush=True)
    rows = {
        "chain": dict(launches=launches["chain"], max_abs_err=err_chain, ms=chain_ms,
                      plain_ms=chain_plain_ms, bound_ms=chain_bound[0], bound_by=chain_bound[1],
                      library_ms=None),
        "take_along": dict(launches=launches["take_along"], max_abs_err=0.0, ms=s64["ms"],
                           plain_ms=s64["gather_ms"], bound_ms=s64["bound_ms"],
                           bound_by="bytes", library_ms=s64["gather_ms"],
                           floor_ms=s64["bound_ms"] * PEAK_BYTES / rate, floor_by="bytes"),
    }
    return rows, floors, tail_floor


def yuv_oracle(frame: np.ndarray) -> np.ndarray:
    """RGBA -> planar YUV420 (BT.601 limited, 2x2 box chroma) in float64
    NumPy, independent of the port's converter."""
    h, w, _ = frame.shape
    rgb = frame[..., :3].astype(np.float64) / 255.0
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    yp = 0.299 * r + 0.587 * g + 0.114 * b
    y8 = np.clip(16.0 + 219.0 * yp + 0.5, 0, 255).astype(np.uint8)

    def sub(c):
        c = c.reshape(h // 2, 2, w // 2, 2).mean(axis=(1, 3))
        return np.clip(c + 0.5, 0, 255).astype(np.uint8)

    u = 128.0 + 112.0 * (b - yp) / 0.886
    v = 128.0 + 112.0 * (r - yp) / 0.701
    return np.concatenate([y8.reshape(-1), sub(u).reshape(-1), sub(v).reshape(-1)])


def phase11_runtime(lib, dev, renderers, head_sky, thr, tmp):
    """Phase 11: the host runtime at full width — AnimationJob (both
    programs, the raw sink, resume, two devices, yuv420p, a PNG sequence),
    the Session at two presets, the CLI as subprocesses and the previews.
    `renderers` are phase 5's 1080p compact and inline renderers, `thr`
    their pipelined ms/frame."""
    import io as _io
    import os
    import sys

    from relativisticraytracer_tpu_torch.config import RenderSettings, SceneConfig
    from relativisticraytracer_tpu_torch.io import video as tvideo
    from relativisticraytracer_tpu_torch.io.image import decode_png
    from relativisticraytracer_tpu_torch.ops.cuda_lib import BUILD_DIR, REPLAY_PASSES
    from relativisticraytracer_tpu_torch.paths import default_paths, interpolate_path
    from relativisticraytracer_tpu_torch.render.camera import camera_state_from_pose
    from relativisticraytracer_tpu_torch.render.pipeline import Renderer
    from relativisticraytracer_tpu_torch.runtime import framesink, profiling
    from relativisticraytracer_tpu_torch.runtime.app import AnimationJob, Session
    from relativisticraytracer_tpu_torch.runtime.preview import run_terminal_preview

    path = default_paths()[0]
    fps, n = 24, 12
    hw, hh = 1920, 1080
    has_ffmpeg = tvideo.ffmpeg_available()
    sink = "native" if framesink._load_library() is not None else "Python"
    real_ffmpeg_available = tvideo.ffmpeg_available
    tvideo.ffmpeg_available = lambda: False  # the raw sink: its bytes are checkable
    os.environ["RRT_RECORDING_DIR"] = str(tmp / "recordings")

    def frame_at(r, k):
        t = (k + 1) / fps
        return r.render_np(camera_state_from_pose(*interpolate_path(path, t)), None, t)

    def job(r, name, **kw):
        kw.setdefault("duration", n / fps)
        # os.path.join keeps a trailing "/" (a PNG-sequence target); pathlib drops it
        return AnimationJob(path=path, renderer=r, fps=fps, out_path=os.path.join(tmp, name),
                            **kw)

    try:
        files = {}
        for prog, r in renderers.items():
            job(r, f"warm_{prog}.rgba", duration=2 / fps).run(resume=False)
            lib.reset_launches()
            intervals = []
            stats = job(r, f"{prog}.rgba").run(
                resume=False, progress=lambda k, total, ms: intervals.append(ms))
            ran = {k: v for k, v in lib.launches.items() if v}
            raw = np.fromfile(stats["out_path"], np.uint8).reshape(n, hh, hw, 4)
            files[prog] = pathlib.Path(stats["out_path"]).read_bytes()
            same = all(np.array_equal(raw[k], frame_at(r, k)) for k in (0, n - 1))
            with profiling.trace(str(ROOT / "chiprun_out" / f"job_trace_{prog}")) as prof:
                t0 = time.perf_counter()
                job(r, f"traced_{prog}.rgba", duration=4 / fps).run(resume=False)
                wall = (time.perf_counter() - t0) * 1000.0
            busy, span, _, _ = device_busy(prof)
            idle = "not measured (no device events)" if busy is None else (
                f"{1.0 - busy / wall:.3f} of the run's wall time (busy {busy:.3f} of "
                f"{wall:.3f} ms), {1.0 - busy / span:.3f} of the device span "
                f"({span:.3f} ms)")
            print(f"phase 11 job {prog} 1920x1080 x {n} frames ({sink} sink, raw): "
                  f"mean_frame_ms {stats['mean_frame_ms']:.3f} (phase 5 pipelined "
                  f"{thr[prog]:.3f}; the wall includes opening the sink and its final "
                  f"flush), median interval between frames reaching the sink "
                  f"{np.median(intervals[1:]):.3f} ms; frames 0 and {n - 1} bitwise "
                  f"render_np {same}; traced 4 "
                  f"frames: cudaStreamSynchronize {host_syncs(prof) / 4:.2f} a frame, "
                  f"cudaEventSynchronize {host_syncs(prof, 'cudaEventSynchronize') / 4:.2f} a "
                  f"frame, device idle share {idle}; launches {ran}", flush=True)
            if not same or stats["frames_written"] != n:
                raise AssertionError(f"{prog} job: frames differ from render_np or missing")
            if host_syncs(prof):  # neither frame program waits for the device
                raise AssertionError(f"{prog} job: {host_syncs(prof)} cudaStreamSynchronize")
            want = ({"march_sky", "sky"} if prog == "inline"
                    else {"record", "sky"} | set(REPLAY_PASSES))
            if not want <= set(ran):
                raise AssertionError(f"{prog} job did not run its kernels: {ran}")
        if files["compact"] != files["inline"]:
            raise AssertionError("compact and inline jobs wrote different bytes")
        # the compact job's replay traffic, frame by frame
        from relativisticraytracer_tpu_torch.tools.replay_traffic import frame_traffic

        rc = renderers["compact"]
        jt = [frame_traffic(rc.scene, rc.settings, (k + 1) / fps,
                            interpolate_path(path, (k + 1) / fps), dev, lib) for k in range(n)]
        print(f"phase 11 compact job's replay traffic (frame: steps S, steps a pixel, rounds "
              f"used, rays past the rounds of the {jt[0]['capacity']}-entry step list): "
              + "; ".join(f"{k} {r['steps']} {r['density']:.2f} {r['rounds_used']} "
                          f"{r['rays_past']}" for k, r in enumerate(jt)), flush=True)

        # the device->host copy of one frame, pinned and pageable
        r = renderers["compact"]
        dev_frame = r.render(camera_state_from_pose(*interpolate_path(path, 1 / fps)), None,
                             1 / fps)
        host = torch.empty(dev_frame.shape, dtype=torch.uint8, pin_memory=True)
        d2h = event_ms(lambda: host.copy_(dev_frame, non_blocking=True), reps=10)
        _, pageable = sync_ms(lambda: dev_frame.cpu(), reps=10)

        # yuv420p
        stats = job(r, "yuv.mp4", transfer="yuv420p").run(resume=False)
        yuv = pathlib.Path(stats["out_path"]).read_bytes()
        fb = hw * hh * 3 // 2
        got0 = np.frombuffer(yuv[:fb], np.uint8)
        want0 = yuv_oracle(np.frombuffer(files["compact"][:hw * hh * 4], np.uint8)
                           .reshape(hh, hw, 4))
        d = np.abs(got0.astype(int) - want0)
        from relativisticraytracer_tpu_torch.render.postfx import yuv420_from_rgba8

        yuv_frame = yuv420_from_rgba8(dev_frame)
        yuv_d2h = event_ms(lambda: host.view(-1)[:fb].copy_(yuv_frame, non_blocking=True),
                           reps=10)
        print(f"phase 11 transfer yuv420p: file {len(yuv)} bytes (= {n} x {fb}; rgba "
              f"{len(files['compact'])} = {n} x {hw * hh * 4}); frame 0 vs the float64 oracle "
              f"on the RGBA frame: max |d| {int(d.max())}, {int((d > 0).sum())} of {fb} bytes "
              f"differ; D2H per frame pinned rgba {d2h:.3f} ms, yuv420p {yuv_d2h:.3f} ms, "
              f"pageable rgba .cpu() {pageable:.3f} ms", flush=True)
        if len(yuv) != n * fb or d.max() > 1:
            raise AssertionError("yuv420p job: wrong size or frame 0 off the oracle")

        # resume: interrupted after 5 frames, then run(resume=True)
        class Interrupt(RuntimeError):
            pass

        def stop_at_5(k, total, ms):
            if k >= 5:
                raise Interrupt()

        resumed = job(r, "resumed.rgba", checkpoint_every=2)
        try:
            resumed.run(resume=False, progress=stop_at_5)
            raise AssertionError("the interrupted job ran to its end")
        except Interrupt:
            pass
        rstats = resumed.run(resume=True)
        same_resume = (tmp / "resumed.rgba").read_bytes() == files["compact"]
        # two devices (one card twice), traced: a card's frame is dispatched
        # without waiting for the other's
        with profiling.trace(str(ROOT / "chiprun_out" / "job_trace_devices")) as prof:
            dstats = job(r, "devices.rgba").run(resume=False, devices=["cuda:0", "cuda:0"])
        same_devices = (tmp / "devices.rgba").read_bytes() == files["compact"]
        dev_syncs = host_syncs(prof)
        # a PNG sequence, decoded by the port's reader
        t0 = time.perf_counter()
        job(r, "png/", duration=4 / fps).run(resume=False)
        png_s = time.perf_counter() - t0
        pngs = sorted((tmp / "png").glob("frame_*.png"))
        same_png = len(pngs) == 4 and all(
            np.array_equal(decode_png(p), np.frombuffer(files["compact"], np.uint8)
                           .reshape(n, hh, hw, 4)[k]) for k, p in enumerate(pngs))
        print(f"phase 11 resume after 5 frames: resumed at {rstats['resumed_at']}, file "
              f"byte-identical {same_resume}; devices [cuda:0, cuda:0] ({dstats['devices']} "
              f"devices) byte-identical {same_devices}, traced: cudaStreamSynchronize "
              f"{dev_syncs}, mean_frame_ms {dstats['mean_frame_ms']:.3f}; PNG sequence of 4 "
              f"frames ({png_s:.2f} s) decoded equal {same_png}", flush=True)
        if not (same_resume and same_devices and same_png):
            raise AssertionError("resume, two-device or PNG job differs from the job's file")
        if dev_syncs:
            raise AssertionError(f"two-device job: {dev_syncs} cudaStreamSynchronize")
        if has_ffmpeg:  # the MP4 sink through the machine's ffmpeg
            tvideo.ffmpeg_available = real_ffmpeg_available
            mstats = job(r, "clip.mp4", duration=4 / fps).run(resume=False)
            size = pathlib.Path(mstats["out_path"]).stat().st_size
            print(f"phase 11 MP4 sink (ffmpeg on this machine): {mstats['frames_written']} "
                  f"frames, {size} bytes", flush=True)
            tvideo.ffmpeg_available = lambda: False
        else:
            print("phase 11 MP4 sink: not run, no ffmpeg on this machine (the raw sink and its "
                  "sidecar ran above)", flush=True)

        # the Session at two presets, with its motion renderer
        scene = SceneConfig()
        for preset, (sw, shh), motion_steps in (("realtime", (480, 272), 600),
                                                ("native", (1000, 700), 400)):
            main_r = Renderer(scene, RenderSettings(width=sw, height=shh), skybox=head_sky,
                              device=dev)
            motion_r = Renderer(scene, RenderSettings(width=sw, height=shh,
                                                      max_steps=motion_steps),
                                skybox=main_r.sky, device=dev)
            s = Session(renderer=main_r, motion_renderer=motion_r)
            s.tick(1 / 30)
            ms = {"still": [], "flying": [], "recording": []}
            for phase_name in ms:
                if phase_name == "recording":
                    s.handle_key("r")
                for _ in range(10):
                    if phase_name == "flying":
                        s.handle_key("w")
                        s.mouse(3.0, 0.5)
                    t0 = time.perf_counter()
                    frame = s.tick(1 / 30)
                    ms[phase_name].append((time.perf_counter() - t0) * 1000.0)
            s.handle_key("r")
            rec_files = sorted((tmp / "recordings").glob("*.rgba"))
            rec_bytes = rec_files[-1].stat().st_size if rec_files else 0
            s.close()
            print(f"phase 11 Session {preset} {sw}x{shh} (motion {motion_steps} steps): tick ms "
                  + ", ".join(f"{k} median {np.median(v):.3f}" for k, v in ms.items())
                  + f"; recorded {rec_bytes // (sw * shh * 4)} frames; frame {frame.shape}",
                  flush=True)
            if rec_bytes != 10 * sw * shh * 4 or frame.shape != (shh, sw, 4):
                raise AssertionError(f"Session {preset}: recorded {rec_bytes} bytes")
            for f in rec_files:
                f.unlink()

        # the terminal preview (no Pillow needed) and the JPEG preview
        s = Session(renderer=Renderer(scene, RenderSettings(width=480, height=272),
                                      skybox=head_sky, device=dev))
        out = _io.StringIO()
        t0 = time.perf_counter()
        run_terminal_preview(s, frames=3, width=80, fps_cap=1000.0, out=out)
        term_ms = (time.perf_counter() - t0) * 1000.0 / 3
        if "▀" not in out.getvalue():
            raise AssertionError("terminal preview drew nothing")
        try:
            import PIL.Image  # noqa: F401
        except ImportError:
            jpeg = "PreviewServer /frame.jpg not run: Pillow is not installed on this machine"
        else:
            import http.client

            from relativisticraytracer_tpu_torch.runtime.preview import PreviewServer

            srv = PreviewServer(s, host="127.0.0.1", port=0)
            srv.start()
            try:
                conn = http.client.HTTPConnection("127.0.0.1", srv.port, timeout=120)
                conn.request("GET", "/frame.jpg")
                body = conn.getresponse().read()
                conn.close()
            finally:
                srv.stop()
            if body[:2] != b"\xff\xd8":
                raise AssertionError("/frame.jpg is not a JPEG")
            jpeg = f"PreviewServer /frame.jpg: a {len(body)}-byte JPEG"
        s.close()
        print(f"phase 11 terminal preview 3 frames at 480x272: {term_ms:.1f} ms a frame; {jpeg}",
              flush=True)
    finally:
        tvideo.ffmpeg_available = real_ffmpeg_available

    # the CLI as subprocesses (the library is already built: no nvcc)
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    before = set(BUILD_DIR.glob("*.so"))
    cli = []
    for argv in (["paths"], ["still", "--preset", "cinema", "--out", str(tmp / "still.png")],
                 ["anim", "--preset", "realtime", "--fps", "8", "--duration", "1",
                  "--out", str(tmp / "cli_anim") + "/"]):
        t0 = time.perf_counter()
        subprocess.run([sys.executable, "-m", "relativisticraytracer_tpu_torch", *argv],
                       check=True, capture_output=True, text=True, timeout=600, cwd=tmp, env=env)
        cli.append((argv[0], time.perf_counter() - t0))
    built = set(BUILD_DIR.glob("*.so")) - before
    still = decode_png(tmp / "still.png")
    n_anim = len(list((tmp / "cli_anim").glob("frame_*.png")))
    print("phase 11 CLI (subprocesses): " + ", ".join(f"{c} {w * 1000:.0f} ms" for c, w in cli)
          + f"; kernel build in them: {'none (library cached)' if not built else built}; "
          f"still {still.shape}, anim {n_anim} PNG frames", flush=True)
    if still.shape != (1080, 1920, 4) or n_anim != 8 or built:
        raise AssertionError("CLI runs: wrong outputs or an unexpected kernel build")


# the port's examples on the card: (script, arguments, smoke mode, outputs
# in the working directory and their (height, width) where a PNG)
EXAMPLES = (
    ("render_still.py", [], False, {"still.png": (1080, 1920)}),
    ("custom_scene.py", [], False, {f"custom_t{t}.png": (720, 1280) for t in (0, 5, 10)}),
    ("multi_chip.py", [], False, {"sharded.png": (1080, 1920)}),
    ("render_animation.py", ["0.5"], False, {"flyby.*": None}),
    ("frame_parallel_animation.py", [], True, {"flyby_720p.*": None}),
    ("live_preview.py", [], True, {}),
)


def phase12_entry_points(lib, dev, tmp):
    """Phase 12: the port's user surface on the card — graft_entry.entry()
    (the frame against the plain path, its launches and ms),
    dryrun_multichip(8) on this card's repeated device, the 1080p grid
    bitwise the untiled frame, and the six examples as subprocesses."""
    import os
    import sys

    from relativisticraytracer_tpu_torch import graft_entry
    from relativisticraytracer_tpu_torch.config import CameraEffects, RenderSettings, SceneConfig
    from relativisticraytracer_tpu_torch.io.image import decode_png
    from relativisticraytracer_tpu_torch.ops.cuda_lib import BUILD_DIR, REPLAY_PASSES
    from relativisticraytracer_tpu_torch.render.camera import camera_state_from_pose
    from relativisticraytracer_tpu_torch.render.pipeline import Renderer, render_frame
    from relativisticraytracer_tpu_torch.render.skybox import procedural_starfield

    frame_kernels = ("record",) + REPLAY_PASSES + ("sky",)
    fn, args = graft_entry.entry()
    fn(*args)  # warm-up
    torch.cuda.synchronize()
    lib.reset_launches()
    frame = fn(*args)
    torch.cuda.synchronize()
    entry_launches = {k: v for k, v in lib.launches.items() if v}
    _, entry_ms = sync_ms(lambda: fn(*args), reps=5)
    plain = render_frame(SceneConfig(max_steps=256),
                         RenderSettings(width=256, height=256, max_steps=256), *args,
                         device=dev)
    e = rmse(frame.cpu().numpy(), plain.cpu().numpy())
    print(f"phase 12 graft_entry.entry(): frame {tuple(frame.shape)} {frame.dtype}, RMSE vs the "
          f"plain path on the card {e:.3g}, {entry_ms:.3f} ms a frame (synchronized, mean of 5), "
          f"launches {entry_launches}", flush=True)
    if not (e < 1e-3 and frame.shape == (256, 256, 4)
            and all(entry_launches.get(k, 0) >= 1 for k in frame_kernels)):
        raise AssertionError(f"entry(): RMSE {e}, launches {entry_launches}")

    lib.reset_launches()
    t0 = time.perf_counter()
    dry = graft_entry.dryrun_multichip(8)
    torch.cuda.synchronize()
    dry_s = time.perf_counter() - t0
    dry_launches = {k: v for k, v in lib.launches.items() if v}
    untiled = Renderer(SceneConfig(max_steps=8),
                       RenderSettings(width=1920, height=1080, max_steps=8),
                       skybox_rgba=procedural_starfield(64, 128, device=dev),
                       device=dev).render_np(camera_state_from_pose(*graft_entry.POSE),
                                             CameraEffects(), 1.0)
    equal = np.array_equal(dry["frame_hd"], untiled)
    print(f"phase 12 dryrun_multichip(8): {torch.cuda.device_count()} card(s) served 8 shards, "
          f"{dry_s * 1000.0:.1f} ms for the three stages; the 1080p grid bitwise the untiled frame "
          f"{equal}; job {dry['job']['frames_written']} frames; launches {dry_launches}",
          flush=True)
    if not equal or not all(dry_launches.get(k, 0) >= 1 for k in frame_kernels):
        raise AssertionError(f"dryrun_multichip(8): grid equal {equal}, launches {dry_launches}")

    # the six examples as subprocesses (the library is already built: no nvcc)
    before = set(BUILD_DIR.glob("*.so"))
    examples = ROOT / "relativisticraytracer_tpu_torch" / "examples"
    runs = []
    for name, argv, smoke, outputs in EXAMPLES:
        cwd = tmp / name.removesuffix(".py")
        cwd.mkdir()
        env = dict(os.environ, PYTHONPATH=str(ROOT), RRT_DEVICE="cuda",
                   RRT_RECORDING_DIR=str(cwd))
        env.pop("RRT_EXAMPLE_SMOKE", None)
        if smoke:
            env["RRT_EXAMPLE_SMOKE"] = "1"
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, str(examples / name), *argv], cwd=cwd, env=env,
                              capture_output=True, text=True, timeout=300)
        wall = time.perf_counter() - t0
        runs.append(f"{name}{' ' + ' '.join(argv) if argv else ''}"
                    f"{' (smoke)' if smoke else ''} {wall:.1f} s rc {proc.returncode}")
        if proc.returncode != 0:
            raise AssertionError(f"example {name} exited {proc.returncode}\n{proc.stdout[-2000:]}"
                                 f"\n{proc.stderr[-4000:]}")
        for pattern, hw in outputs.items():
            found = sorted(cwd.glob(pattern))
            if not found:
                raise AssertionError(f"example {name}: no {pattern}")
            if hw is not None and decode_png(found[0]).shape[:2] != hw:
                raise AssertionError(f"example {name}: {pattern} is not {hw}")
        last = proc.stdout.strip().splitlines()[-1] if proc.stdout.strip() else ""
        runs[-1] += f" ({last[:160]})"
    built = set(BUILD_DIR.glob("*.so")) - before
    print("phase 12 examples (subprocesses, RRT_DEVICE=cuda): " + "; ".join(runs)
          + f"; kernel build in them: {'none (library cached)' if not built else built}",
          flush=True)
    if built:
        raise AssertionError(f"examples built the kernels again: {built}")


# the kernels each kernel program launches on the fuzz's scenes (both media on)
FUZZ_KERNELS = {"compact": ("record", "replay_rounds", "replay_march", "replay_shade_disk",
                            "replay_shade_cloud", "replay_composite", "sky"),
                "inline": ("march_sky", "sky")}


SYNC_WARNING = "called a synchronizing CUDA operation"


def counted_syncs(fn):
    """(fn's result, the host syncs torch made in the call): its sync debug
    mode "warn" flags every synchronizing call it makes (a stream or
    device synchronize, a blocking copy, nonzero's count)."""
    import warnings

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return out, sum(SYNC_WARNING in str(w.message) for w in caught)


def traced_syncs(fn):
    """One call of `fn` under torch.profiler (no trace written): the
    cudaStreamSynchronize calls the profiler recorded, and whether an event
    recorded right after `fn` returned was still pending."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        returned = torch.cuda.Event()
        returned.record()
        pending = not returned.query()
        torch.cuda.synchronize()
    return host_syncs(prof), pending


def phase13_loop(lib, dev, head_sky, smi, tmp):
    """Phase 13: the `loop` choice on the card — the fuzz tool
    (tools/fuzz_parity, its defaults: 24 cases, 96x64, 400 steps, both
    spins) for the compact and the inline program against the plain march,
    the launches of each program's kernels in its run, every case bitwise,
    and the seconds of each plain frame; a loop="scan" frame of case 0,
    bitwise its "while" frame, with no host sync (torch's sync debug
    count), and two short plain frames traced (scan: no
    cudaStreamSynchronize; while: at most one sync a chunk); one
    full-size loop="while" frame (the headline) bitwise the compact kernel
    frame, with at most ceil(2000 / chunk) host syncs; the CLI's still with
    --loop while and --loop pallas as subprocesses."""
    import os
    import sys

    from relativisticraytracer_tpu_torch.config import CameraEffects, RenderSettings, SceneConfig
    from relativisticraytracer_tpu_torch.io.image import decode_png
    from relativisticraytracer_tpu_torch.render.camera import camera_state_from_pose
    from relativisticraytracer_tpu_torch.render.pipeline import Renderer
    from relativisticraytracer_tpu_torch.render.skybox import (
        procedural_starfield,
        skybox_from_array,
    )
    from relativisticraytracer_tpu_torch.tools import fuzz_parity

    plain_frames = {}
    reports = {}
    for program in ("compact", "inline"):
        lib.reset_launches()
        t0 = time.perf_counter()
        rep = fuzz_parity.run(media_pass=program, device=dev, plain_frames=plain_frames,
                              log=None)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        ran = {k: v for k, v in lib.launches.items() if v}
        spins = sorted({c["spin"] for c in rep["cases"]})
        reports[program] = dict(rep, launches=ran, wall_s=wall)
        print(f"phase 13 fuzz ({program} kernels vs loop=\"while\", {len(rep['cases'])} cases "
              f"96x64 400 steps, spins {spins}; {smi}): worst RMSE {rep['worst_rmse']:.3g}, "
              f"worst LSB {rep['worst_lsb']}, worst mismatch_frac "
              f"{rep['worst_mismatch_frac']:.5f}, worst share of pixels over 1 LSB "
              f"{rep['worst_over_lsb_frac']:.5f}, cases within 1 LSB "
              f"{sum(c['max_lsb'] <= 1 for c in rep['cases'])}/{len(rep['cases'])}, pass "
              f"{rep['pass']}; {wall:.1f} s (the plain frames rendered in the first run); "
              f"launches {ran}", flush=True)
        missing = [k for k in FUZZ_KERNELS[program] if not ran.get(k)]
        bitwise = sum(c["max_lsb"] == 0 for c in rep["cases"])
        print(f"phase 13 fuzz ({program}): cases bitwise the plain march's frame "
              f"{bitwise}/{len(rep['cases'])}", flush=True)
        if rep["plain_seconds"]:
            secs = rep["plain_seconds"]
            print(f"phase 13 fuzz plain frames (loop=\"while\", 96x64 400 steps; {smi}): "
                  f"{len(secs)} frames {sum(secs):.1f} s, {min(secs):.3f}-{max(secs):.3f} s a "
                  f"frame", flush=True)
        if not rep["pass"] or missing or spins != [0.0, 0.9] or bitwise != len(rep["cases"]):
            bad = [(k, c) for k, c in enumerate(rep["cases"]) if not c["ok"] or c["max_lsb"]]
            raise AssertionError(f"fuzz {program}: failed or not bitwise cases {bad}, kernels "
                                 f"not launched {missing}, spins {spins}")
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    (ROOT / "chiprun_out" / "fuzz_parity_programs.json").write_text(
        json.dumps(dict(device=torch.cuda.get_device_name(dev), power=smi, **reports), indent=1))

    # the plain march's host syncs: a "scan" frame of fuzz case 0 (bitwise
    # its "while" frame) counted by torch, then two short frames traced
    spin, pos, yaw, pitch, t = next(fuzz_parity.poses(1, 7))
    cam0 = camera_state_from_pose(pos, yaw, pitch)
    sky0 = skybox_from_array(procedural_starfield(128, 256, device=dev), dev)
    small = dict(width=96, height=64)
    scan = Renderer(SceneConfig(spin_a=spin, max_steps=400), RenderSettings(loop="scan", **small),
                    skybox=sky0, device=dev)
    t0 = time.perf_counter()
    s_frame, s_syncs = counted_syncs(lambda: scan.render(cam0, CameraEffects(), t))
    s_frame = s_frame.cpu().numpy()
    s_wall = time.perf_counter() - t0
    s_equal = bool(np.array_equal(s_frame, plain_frames[0]))
    traced = {}
    for loop in ("scan", "while"):
        short = Renderer(SceneConfig(spin_a=spin, max_steps=16),
                         RenderSettings(loop=loop, chunk=4, **small), skybox=sky0, device=dev)
        short.render(cam0, CameraEffects(), t)
        torch.cuda.synchronize()
        _, counted = counted_syncs(lambda: short.render(cam0, CameraEffects(), t))
        torch.cuda.synchronize()
        traced[loop] = traced_syncs(lambda: short.render(cam0, CameraEffects(), t)) + (counted,)
    print(f"phase 13 plain march host syncs: loop=\"scan\" 96x64 400 steps (fuzz case 0) "
          f"{s_syncs} (torch's count), {s_wall:.3f} s synchronized, bitwise the \"while\" frame "
          f"{s_equal}; 16 steps with chunk 4, traced: "
          + ", ".join(f"{k} cudaStreamSynchronize {v[0]} (torch's count {v[2]}), device work "
                      f"pending on return {v[1]}" for k, v in traced.items()), flush=True)
    if s_syncs or not s_equal or traced["scan"][0] or traced["scan"][2]:
        raise AssertionError(f"scan frame: syncs {s_syncs}, bitwise while {s_equal}, traced "
                             f"{traced}")
    if not 0 < traced["while"][2] <= 4:
        raise AssertionError(f"short while frame: traced {traced['while']}")

    # one full-size loop="while" frame: the headline against the compact kernel frame
    scene = SceneConfig()
    cam = camera_state_from_pose(*HEADLINE["pose"])
    eff = CameraEffects()
    wh = dict(width=HEADLINE["width"], height=HEADLINE["height"])
    kern = Renderer(scene, RenderSettings(**wh), skybox=head_sky, device=dev)
    plain = Renderer(scene, RenderSettings(loop="while", **wh), skybox=head_sky, device=dev)
    kern.render(cam, eff, 1.0)
    k_frame, k_ms = sync_ms(lambda: kern.render(cam, eff, 1.0), reps=3)
    lib.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    w_frame, w_syncs = counted_syncs(lambda: plain.render(cam, eff, 1.0))
    torch.cuda.synchronize()
    w_ms = (time.perf_counter() - t0) * 1000.0
    w_launches = {k: v for k, v in lib.launches.items() if v}
    c = fuzz_parity.compare(k_frame.cpu().numpy(), w_frame.cpu().numpy(), 1)
    most = -(-scene.max_steps // plain.settings.chunk)
    print(f"phase 13 loop=\"while\" {wh['width']}x{wh['height']} {scene.max_steps} steps "
          f"(headline pose, 2048x4096 starfield; {smi}): {w_ms:.1f} ms synchronized against the "
          f"compact kernel frame's {k_ms:.3f} ms (mean of 3); RMSE {c['rmse']:.3g}, max LSB "
          f"{c['max_lsb']}, share of pixels over 1 LSB {c['over_lsb_frac']:.5f}; kernel launches "
          f"in the while frame {w_launches or 'none'}; host syncs {w_syncs} (torch's count, at "
          f"most {most}: one a chunk of {plain.settings.chunk})", flush=True)
    if c["max_lsb"] or w_launches or w_syncs > most:
        raise AssertionError(f"while frame: RMSE {c['rmse']}, max LSB {c['max_lsb']}, launches "
                             f"{w_launches}, syncs {w_syncs}")

    # the CLI's --loop as subprocesses (the library is already built)
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    frames, walls = {}, []
    for loop in ("while", "pallas"):
        out = tmp / f"loop_{loop}.png"
        t0 = time.perf_counter()
        subprocess.run([sys.executable, "-m", "relativisticraytracer_tpu_torch", "still",
                        "--loop", loop, "--width", "96", "--height", "64", "--max-steps", "64",
                        "--out", str(out)],
                       check=True, capture_output=True, text=True, timeout=600, cwd=tmp, env=env)
        walls.append(f"--loop {loop} {time.perf_counter() - t0:.1f} s")
        frames[loop] = decode_png(out)
    c = fuzz_parity.compare(frames["pallas"], frames["while"], 1)
    print(f"phase 13 CLI still 96x64 64 steps (subprocesses): {', '.join(walls)}; frames "
          f"{frames['while'].shape} and {frames['pallas'].shape}, RMSE {c['rmse']:.3g}, max LSB "
          f"{c['max_lsb']}, share of pixels over 1 LSB {c['over_lsb_frac']:.5f}", flush=True)
    if not c["ok"] or frames["while"].shape != (64, 96, 4):
        raise AssertionError(f"CLI --loop frames: {c}, shape {frames['while'].shape}")


def main() -> None:
    t_main = time.perf_counter()
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() is False)")

    from relativisticraytracer_tpu_torch.config import (
        CameraEffects,
        RenderSettings,
        SceneConfig,
        effects_off,
    )
    from relativisticraytracer_tpu_torch.core.vecmath import Vec3, normalize
    from relativisticraytracer_tpu_torch.ops import cuda_lib
    from relativisticraytracer_tpu_torch.ops.cuda_lib import REPLAY_PASSES
    from relativisticraytracer_tpu_torch.ops import pallas_compact as pc
    from relativisticraytracer_tpu_torch.ops import pallas_march as pm
    from relativisticraytracer_tpu_torch.ops import pallas_sky as ps
    from relativisticraytracer_tpu_torch.ops.camera_rays import rays_from_scalars
    from relativisticraytracer_tpu_torch.parallel import sharding
    from relativisticraytracer_tpu_torch.render import march as march_mod
    from relativisticraytracer_tpu_torch.render.camera import (
        camera_state_from_pose,
        uv_planes,
    )
    from relativisticraytracer_tpu_torch.render.pipeline import Renderer, render_frame
    from relativisticraytracer_tpu_torch.render.postfx import (
        apply_effects_and_tonemap,
        pack_rgba8,
    )
    from relativisticraytracer_tpu_torch.render.skybox import (
        procedural_starfield,
        sample_sky_fast,
        sky_coords,
        skybox_from_array,
    )
    from relativisticraytracer_tpu_torch.tools import replay_traffic, roofline

    dev = torch.device("cuda:0")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(f"phase 1 device: {kind} | count {torch.cuda.device_count()} | "
          f"torch {torch.__version__} cuda {torch.version.cuda} | nvidia-smi: {smi}",
          flush=True)

    t0 = time.perf_counter()
    lib = cuda_lib.kernels()
    print(f"phase 2 build: {time.perf_counter() - t0:.1f} s (nvcc {lib.build_seconds:.1f} s)",
          flush=True)
    kernel = "?"
    for line in lib.build_log.splitlines():
        if "Compiling entry function" in line:
            m = re.search(r"function '_Z(\d+)", line)  # the mangled name's identifier
            kernel = line[m.end():m.end() + int(m.group(1))] if m else line.strip()
            flags = re.search(r"ILb(\d)ELb(\d)E", line)
            if flags and kernel.startswith("march"):  # the fused march's (has_spin, has_mass_pos)
                kernel += f"<spin {flags.group(1)}, mass_pos {flags.group(2)}>"
        elif "registers" in line or "spill" in line:
            print(f"  ptxas {kernel}: {line.split(':', 1)[-1].strip()}")
    n_sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for name in ("record", "march_sky", "march_camera", "march_planes"):
        threads = 256 if name == "record" else 32
        a = lib.attrs(name, threads, dev)
        print(f"  occupancy {name}: {a['regs']} registers, {a['local_bytes']} B local a "
              f"thread; {a['blocks_per_sm']} blocks of {threads} threads an SM = "
              f"{a['blocks_per_sm'] * threads // 32} warps")
    print(f"  march launch geometry: {cuda_lib.TILE_W}x{cuda_lib.TILE_H} pixel tiles, one warp "
          f"a block, expensive tiles first; tiles (= blocks): 1920x1080 "
          f"{cuda_lib.tile_count(1920, 1080)}, a 270x960 shard {cuda_lib.tile_count(960, 270)}, "
          f"192x108 {cuda_lib.tile_count(192, 108)}")
    sass = roofline.library_sass(lib)
    # sm_90 kernels read their parameters (SceneConsts first) from c[0x0][0x210] on
    flag_offsets = [0x210 + getattr(cuda_lib.SceneConsts, f).offset
                    for f in ("enable_disk", "enable_clouds", "has_spin", "has_mass_pos")]
    for sym, st in roofline.step_stats(sass, flag_offsets).items():
        print(f"  SASS {sym}: march loop {st}")
    errs = {}

    # ---- phase 3: kernels vs plain versions on the card
    scene = SceneConfig()
    cam = camera_state_from_pose((0.0, 10.0, -60.0), 0.0, -10.0)
    eff = CameraEffects()
    small_sky = skybox_from_array(np.load(STARFIELD), dev)
    w, h, steps, t = 192, 108, 2000, 10.0
    scal = pc.pack_camera_scalars(cam, eff, t)
    args = (scene, scal, w, h, steps, pc.SLOTS, *small_sky.shape, dev)
    rk = pc._record_cuda(*args, lib)
    rp = pc._record_plain(*args)
    torch.cuda.synchronize()
    hit_k, hit_p = rk.hit > 0.5, rp.hit > 0.5
    hit_mis = (hit_k != hit_p).float().mean().item()
    same = ~(hit_k ^ hit_p)
    idx_eq = bool(torch.equal(rk.idx[:, same], rp.idx[:, same]))
    fxy_err = max((rk.fx - rp.fx)[:, same].abs().max().item(),
                  (rk.fy - rp.fy)[:, same].abs().max().item())
    total_eq = (rk.total == rp.total).float().mean().item()
    print(f"phase 3 record {w}x{h} {steps} steps: hit mismatch {hit_mis:.2e}, "
          f"idx equal where hit agrees {idx_eq}, max |dfx|,|dfy| {fxy_err:.3g}, "
          f"recorded length equal on {total_eq:.4f} of pixels", flush=True)
    if not (hit_mis < 1e-3 and idx_eq):
        raise AssertionError("record kernel disagrees with its plain version")
    errs["record"] = fxy_err

    order, rsteps = pc.replay_list(rk.total)
    ik, tk = pc.media_replay_sorted(scene, rk, t, lib=lib, max_steps=steps)
    ip = torch.zeros((3, h * w), device=dev)
    tp = torch.ones(h * w, device=dev)
    sel = order.long()
    ip[:, sel], tp[sel] = pc._replay_plain(scene, rk.rec, t, sel)
    got = torch.stack([ik.x, ik.y, ik.z, tk]).reshape(4, -1)
    want = torch.cat([ip, tp[None]])
    torch.testing.assert_close(got, want, rtol=2e-6, atol=5e-7)
    errs["replay"] = (got - want).abs().max().item()
    print(f"phase 3 replay {order.numel()} rays, {rsteps} steps (march, shade, composite "
          f"passes): max |d(I,T)| {errs['replay']:.3g} (rtol 2e-6, atol 5e-7; bitwise "
          f"{bool(torch.equal(got, want))})", flush=True)
    # forced step lists: of 1 step (the rays longer than it go to the
    # per-ray kernel), of a third of the steps (at least 3 rounds) and of
    # half; each bitwise the plain replay, with each round's ms
    errs["replay_overflow"] = 0.0
    for name, cap in (("one step", 1), ("a third", rsteps // 3), ("half", rsteps // 2)):
        plan = pc.replay_plan(rk.total, cap, lib=lib)
        fi, ft = pc._replay(scene, rk.rec, t, plan, lib)
        fgot = torch.stack([fi.x, fi.y, fi.z, ft]).reshape(4, -1)
        m, m_r = plan.counts[:2].tolist()
        used = [r for r in plan.rounds.tolist() if r[1]]
        r_ms, ov_ms = round_ms(pc, lib, scene, rk.rec, t, plan, dev)
        errs["replay_overflow"] = max(errs["replay_overflow"], (fgot - want).abs().max().item())
        print(f"phase 3 replay at capacity {cap} ({name}): rounds with rays {len(used)} of "
              f"{len(r_ms)} (rays {[r[1] for r in used]}), {m - m_r} of {m} rays to the per-ray "
              f"kernel; bitwise the plain replay {bool(torch.equal(fgot, want))}; round ms "
              f"{[round(x, 4) for x in r_ms]}, per-ray kernel {ov_ms:.4f} ms", flush=True)
        if not torch.equal(fgot, want):
            raise AssertionError(f"replay at capacity {cap} is not bitwise the plain replay")
        if name == "a third" and len(used) < 3:
            raise AssertionError(f"a third of the steps ran {len(used)} rounds, not 3 or more")

    head_sky = skybox_from_array(procedural_starfield(2048, 4096, device=dev), dev)
    rng = np.random.default_rng(7)
    sky_err = 0.0
    for (sky_name, sky), n_side in ((s, n) for s in (("64x128", small_sky),
                                                     ("2048x4096", head_sky))
                                    for n in ((256, 512), (255, 511))):  # n % 4: 0, 1
        v = rng.standard_normal((3,) + n_side).astype(np.float32)
        v /= np.linalg.norm(v, axis=0, keepdims=True)
        yy, xx = np.meshgrid(np.linspace(-0.4, 0.4, n_side[0]),
                             np.linspace(-0.7, 0.7, n_side[1]), indexing="ij")
        smooth = normalize(Vec3(*(torch.as_tensor(a, dtype=torch.float32, device=dev)
                                  for a in (xx, yy, np.ones_like(xx)))))
        rand = Vec3(*(torch.as_tensor(a, device=dev) for a in v))
        mask_plane = torch.as_tensor(rng.random(n_side) < 0.3, device=dev)
        for dirs_name, d in (("random", rand), ("smooth", smooth)):
            for e in (effects_off(), CameraEffects(use_chromatic_aberration=1.0,
                                                   ca_amount=0.01)):
                coords = sky_coords(d, e.ca_offset(), *sky.shape)
                idx, fx, fy = (torch.stack([c[j] for c in coords]) for j in range(3))
                for masked in (mask_plane, None):
                    bk = ps.sky_background_windowed(sky, idx, fx, fy, e, masked, lib=lib)
                    bp = ps._sky_plain(sky, idx, fx, fy, e, masked)
                    bk = torch.stack(list(bk))
                    keep = (~masked if masked is not None
                            else torch.ones(n_side, dtype=torch.bool, device=dev))
                    if not torch.equal(bk[:, keep], bp[:, keep]):
                        raise AssertionError(f"sky kernel not bitwise ({sky_name}, {dirs_name}, "
                                             f"{n_side})")
                    if bool((bk[:, ~keep] != 0).any()):
                        raise AssertionError("sky kernel wrote a masked pixel")
                    sky_err = max(sky_err, (bk - bp)[:, keep].abs().max().item())
    errs["sky"] = sky_err
    print("phase 3 sky: bitwise on unmasked pixels (2 skies x n % 4 in {0, 1} x random/smooth "
          "x CA off/on x mask/no mask)", flush=True)

    def march_errs(k, p, with_sky: bool):
        """(hit mismatch, max |d| where hits agree) of a fused march kernel's
        outputs `k` against its plain version's `p`; raises past the bar."""
        if with_sky:  # no hit plane: captured rays have T exactly 0
            hk, hp = k[1] == 0, p[1] == 0
            rest = [(k[3], p[3]), (k[4], p[4])]
        else:
            hk, hp = k[2], p[2]
            rest = [(torch.stack(list(k[3])), torch.stack(list(p[3])))]
        mis = (hk != hp).float().mean().item()
        same = hk == hp
        pairs = [(torch.stack(list(k[0])), torch.stack(list(p[0]))),
                 (k[1][None], p[1][None])] + rest
        err = 0.0
        for got, want in pairs:
            torch.testing.assert_close(got[:, same], want[:, same], rtol=2e-6, atol=5e-7)
            err = max(err, (got - want)[:, same].abs().max().item())
        if with_sky and not torch.equal(k[2][:, same], p[2][:, same]):
            raise AssertionError("march_sky: sky indices differ where hits agree")
        if not mis < 1e-3:
            raise AssertionError(f"hit mismatch {mis}")
        return mis, err

    o, d = rays_from_scalars(scal, w, h, dev)
    margs = (scene, scal, w, h, steps)
    for name, run_k, run_p, with_sky in (
        ("march_sky", lambda: pm._march_camera_sky_cuda(*margs, *small_sky.shape, dev, lib),
         lambda: pm._march_camera_sky_plain(*margs, *small_sky.shape, dev), True),
        ("march_camera", lambda: pm._march_camera_cuda(*margs, dev, lib),
         lambda: pm._march_camera_plain(*margs, dev), False),
        ("march_planes", lambda: pm._march_planes_cuda(scene, o, d, t, steps, lib),
         lambda: pm._march_plain(scene, o, d, t, steps), False),
    ):
        k, p = run_k(), run_p()
        torch.cuda.synchronize()
        mis, errs[name] = march_errs(k, p, with_sky)
        print(f"phase 3 {name} {w}x{h} {steps} steps: hit mismatch {mis:.2e}, max |d| where "
              f"hits agree {errs[name]:.3g} (rtol 2e-6, atol 5e-7)"
              + (", sky indices equal" if with_sky else ""), flush=True)

    # the march's tile-key kernel (its order key) against its plain twin
    consts = cuda_lib.scene_consts(scene)
    stream = cuda_lib.current_stream(dev)
    rays = torch.stack(list(o) + list(d))
    kp = cuda_lib.tile_keys_plain(consts, o, d, steps)
    key_err = 0
    for src, kk in (("camera", lib.tile_keys(consts, cuda_lib.cam_scalars(scal), None, w, h,
                                             steps, stream)),
                    ("planes", lib.tile_keys(consts, None, rays, w, h, steps, stream))):
        key_err = max(key_err, int((kk - kp).abs().max()))
    order = lib.march_order(consts, None, rays, w, h, steps, stream)
    perm = bool(torch.equal(torch.sort(order.long()).values,
                            torch.arange(cuda_lib.tile_count(w, h), device=dev)))
    print(f"phase 3 march tile keys {w}x{h}: max |d key| vs plain {key_err} steps (camera and "
          f"planes; at most 1), order a permutation of the tiles {perm}; keys "
          f"{int(kp.min())}-{int(kp.max())}", flush=True)
    if not (key_err <= 1 and perm):
        raise AssertionError("march tile keys disagree with their plain twin")

    # ---- phase 4: the golden cases through the renderer on the card
    sky_small_rgba = np.load(STARFIELD)
    worst = 0.0
    for name, kw, fx_on, (gw, gh), pose, gt, gsteps in GOLDEN_CASES:
        r = Renderer(SceneConfig(max_steps=gsteps, **kw),
                     RenderSettings(width=gw, height=gh, max_steps=gsteps),
                     skybox_rgba=sky_small_rgba, device=dev)
        lib.reset_launches()
        got = r.render_np(camera_state_from_pose(*pose),
                          CameraEffects() if fx_on else effects_off(), gt)
        ran = sorted(k for k, v in lib.launches.items() if v)
        e = rmse(got, np.load(GOLDEN_DIR / f"{name}.npy"))
        worst = max(worst, e)
        print(f"phase 4 golden {name}: RMSE {e:.3g}, kernels {ran}", flush=True)
        if not e < 1e-3:
            raise AssertionError(f"golden {name}: RMSE {e} >= 1e-3")
        vacuum = not (r.scene.enable_disk or r.scene.enable_clouds)
        want = ["march_sky", "sky"] if vacuum else sorted(
            ["record", "sky"] + [k for k in REPLAY_PASSES
                                 if r.scene.enable_clouds or k != "replay_shade_cloud"])
        if ran != want:
            raise AssertionError(f"golden {name} ran the wrong kernels: {ran}")

    nosky_settings = RenderSettings(width=w, height=h, max_steps=steps)
    lib.reset_launches()
    got = Renderer(scene, nosky_settings, device=dev).render(cam, eff, t)
    torch.cuda.synchronize()
    nosky_launch = lib.launches["march_camera"]
    want = render_frame(scene, nosky_settings, cam, eff, t, None, device=dev)
    e = rmse(got.cpu().numpy(), want.cpu().numpy())
    print(f"phase 4 no-sky {w}x{h}: RMSE vs plain path {e:.3g}, march_camera launches "
          f"{nosky_launch}", flush=True)
    if not (e < 1e-3 and nosky_launch == 1):
        raise AssertionError(f"no-sky frame: RMSE {e}, launches {lib.launches}")

    # ---- phase 5: the headline frame
    hw, hh = HEADLINE["width"], HEADLINE["height"]
    settings = RenderSettings(width=hw, height=hh)
    hcam = camera_state_from_pose(*HEADLINE["pose"])
    renderer = Renderer(scene, settings, skybox=head_sky, device=dev)
    renderer.render(hcam, eff, 1.0)  # warm-up
    torch.cuda.synchronize()
    lib.reset_launches()
    frame = renderer.render(hcam, eff, 1.0)
    torch.cuda.synchronize()
    pass_launches = {k: lib.launches[k] for k in REPLAY_PASSES}
    launches = {"record": lib.launches["record"],
                "replay": sum(v for k, v in pass_launches.items() if k != "replay_overflow"),
                "replay_overflow": pass_launches["replay_overflow"], "sky": lib.launches["sky"]}
    lat = [sync_ms(lambda i=i: renderer.render(hcam, eff, 1.0 + i / 24.0))[1]
           for i in range(5)]
    _, thr = sync_ms(lambda: [renderer.render(hcam, eff, 10.0 + i / 24.0)
                              for i in range(5)])
    thr /= 5
    torch.cuda.reset_peak_memory_stats(dev)
    renderer.render(hcam, eff, 1.0)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(dev)

    hscal = pc.pack_camera_scalars(hcam, eff, 1.0)
    hargs = (scene, hscal, hw, hh, scene.max_steps, pc.SLOTS, *head_sky.shape, dev)
    rec = pc._record_cuda(*hargs, lib)
    horder, hsteps = pc.replay_list(rec.total)
    hcap = pc.step_capacity(hw * hh, scene.max_steps)
    hrounds = pc.replay_rounds(hw * hh, scene.max_steps, hcap)
    hplan = pc.replay_plan(rec.total, hcap, rounds=hrounds, lib=lib)
    masked = rec.hit > 0.5
    inten, trans = pc._replay(scene, rec.rec, 1.0, hplan, lib)
    bg = ps.sky_background_windowed(head_sky, rec.idx, rec.fx, rec.fy, eff, masked,
                                    lib=lib)
    ms = {
        "record": event_ms(lambda: pc._record_cuda(*hargs, lib)),
        # the replay's kernels on a built plan (step list and I, T allocated):
        # every round, the empty ones included, and the per-ray kernel
        "replay": event_ms(lambda: pc._replay(scene, rec.rec, 1.0, hplan, lib)),
        "sky": event_ms(lambda: ps.sky_background_windowed(head_sky, rec.idx, rec.fx,
                                                           rec.fy, eff, masked, lib=lib)),
    }
    plan_ms = event_ms(lambda: pc.replay_plan(rec.total, hcap, rounds=hrounds, lib=lib))
    # the replay stage as the frame runs it (plan, every round, the per-ray
    # kernel), and with its plan cut to one round: the rounds this frame
    # leaves empty cost the difference
    stage_ms = {n_r: event_ms(lambda n_r=n_r: pc._replay(
        scene, rec.rec, 1.0, pc.replay_plan(rec.total, hcap, rounds=n_r, lib=lib), lib))
        for n_r in (hrounds, 1)}

    # the replay's passes one by one (round 0, which holds every step), on
    # the frame's step list; the rounds kernel alone; the empty rounds
    consts, stream = cuda_lib.scene_consts(scene), cuda_lib.current_stream(dev)
    pos, vel, emit = pc.step_list(hcap, dev)
    i_l, t_l = torch.zeros((3, hh, hw), device=dev), torch.ones((hh, hw), device=dev)
    csum = torch.cat([hplan.offsets, hplan.counts[2:3]])
    tbl, cnt = torch.empty_like(hplan.rounds), torch.empty_like(hplan.counts)
    pass_ms = {
        "replay_rounds": event_ms(lambda: lib.replay_rounds(csum, hplan.counts[0], hcap, tbl,
                                                            cnt, stream)),
        "replay_march": event_ms(lambda: lib.replay_march(consts, rec.rec, hplan, 0, pos, vel,
                                                          stream)),
        "replay_shade_disk": event_ms(lambda: lib.replay_shade(consts, 1.0, "disk", hplan, 0,
                                                               pos, vel, emit, stream)),
        # the cloud pass finishes what the disk pass wrote: time the two, less the disk's
        "replay_shade_cloud": event_ms(lambda: (
            lib.replay_shade(consts, 1.0, "disk", hplan, 0, pos, vel, emit, stream),
            lib.replay_shade(consts, 1.0, "cloud", hplan, 0, pos, vel, emit, stream))),
        "replay_composite": event_ms(lambda: lib.replay_composite(hplan, 0, emit, i_l, t_l,
                                                                  stream)),
        # every ray in round 0: the launch exits at once
        "replay_overflow": event_ms(lambda: lib.replay_overflow(consts, 1.0, rec.rec, hplan,
                                                                i_l, t_l, stream)),
    }
    pass_ms["replay_shade_cloud"] -= pass_ms["replay_shade_disk"]
    empty_ms = event_ms(lambda: [pc.replay_round(lib, consts, scene, 1.0, rec.rec, hplan, r, pos,
                                                 vel, emit, i_l, t_l, stream)
                                 for r in range(1, hrounds)])
    if not (torch.equal(tbl, hplan.rounds) and torch.equal(cnt, hplan.counts)):
        raise AssertionError("the rounds kernel rebuilt another table")
    lengths = pc.step_lengths(rec.rec, horder)
    list_bytes = sum(t.numel() * 4 for t in (pos, vel, emit))
    seg = rec.rec[:, 6].reshape(pc.SLOTS, -1)
    seg = seg[seg > 0]
    replay_shape = (f"longest ray {int(lengths.max())} steps, longest segment "
                    f"{int(seg.max())}, rays over 1000 steps {int((lengths > 1000).sum())}, "
                    f"segments {seg.numel()}")
    if hplan.rounds[0].tolist() != [0, horder.numel(), 0, hsteps]:
        raise AssertionError(f"the headline's round 0 does not hold every step: {hplan.rounds}")

    # forced step lists: of 1 step (every ray longer than it to the per-ray
    # kernel), of a third of the steps (at least 3 rounds) and of half (the
    # tail past the first half of the steps through the rounds); each
    # bitwise the plain replay of every ray, with each round's ms. The
    # plain replay runs the per-ray kernel's rays at one step apart (its
    # plain time) from the few that rounds of one step take.
    one = pc.replay_plan(rec.total, 1, lib=lib)
    p_one, r_one = one.rounds[0, 0].item(), one.rounds[-1].tolist()
    end_one = r_one[0] + r_one[1]
    ov_sel = torch.cat([horder[:p_one], horder[end_one:]]).long()
    (ov_i, ov_t), ov_plain_ms = sync_ms(lambda: pc._replay_plain(scene, rec.rec, 1.0, ov_sel))
    in_sel = horder[p_one:end_one].long()
    in_i, in_t = pc._replay_plain(scene, rec.rec, 1.0, in_sel)
    want_all = torch.cat([torch.zeros((3, hh * hw), device=dev), torch.ones((1, hh * hw),
                                                                           device=dev)])
    for sel_, i_, t_ in ((ov_sel, ov_i, ov_t), (in_sel, in_i, in_t)):
        want_all[:3, sel_], want_all[3, sel_] = i_, t_
    unforced = torch.cat([torch.stack(list(inten)).reshape(3, -1), trans.reshape(1, -1)])
    # the per-ray kernel's rays at one step: their steps are the unforced
    # list's entries outside the rounds' rays (the same order and offsets);
    # their probes size the kernel's bound
    off = hplan.offsets
    keep = torch.ones(hsteps, dtype=torch.bool, device=dev)
    keep[off[p_one]:(off[end_one] if end_one < off.numel() else hsteps)] = False
    ov_rel = Vec3(pos[:hsteps, 0][keep], pos[:hsteps, 1][keep], pos[:hsteps, 2][keep])
    ov_r2 = ov_rel.x * ov_rel.x + ov_rel.y * ov_rel.y + ov_rel.z * ov_rel.z
    ov_zd, ov_zc = march_mod.media_zones(scene, ov_rel, ov_r2)
    ov_pd, ov_pc = march_mod.media_probes(scene, ov_rel, ov_zd, ov_zc, torch.ones_like(ov_zd))
    overflow_work = (int(keep.sum()), int(ov_pd.sum()), int(ov_pc.sum()),
                     ov_sel.numel() * (4 * 7 * pc.SLOTS + 4 + 16))
    # the rays past the first round at half the steps (its second round's
    # base on): their steps are the unforced list's entries from there
    half_rows = pc.replay_plan(rec.total, hsteps // 2, lib=lib).rounds.tolist()
    t_rel = Vec3(*(pos[half_rows[1][2]:hsteps, c] for c in range(3)))
    t_r2 = t_rel.x * t_rel.x + t_rel.y * t_rel.y + t_rel.z * t_rel.z
    t_zd, t_zc = march_mod.media_zones(scene, t_rel, t_r2)
    t_pd, t_pc = march_mod.media_probes(scene, t_rel, t_zd, t_zc, torch.ones_like(t_zd))
    tail_work = (hsteps - half_rows[1][2], int(t_pd.sum()), int(t_pc.sum()),
                 (horder.numel() - half_rows[1][0]) * (4 * 7 * pc.SLOTS + 4 + 16))
    del pos, vel, emit, keep, ov_rel, ov_r2, ov_zd, ov_zc, ov_pd, ov_pc
    del t_rel, t_r2, t_zd, t_zc, t_pd, t_pc
    forced = {}
    for name, cap in (("one step", 1), ("a third", hsteps // 3), ("half", hsteps // 2)):
        plan = pc.replay_plan(rec.total, cap, lib=lib)
        fi, ft = pc._replay(scene, rec.rec, 1.0, plan, lib)
        fgot = torch.cat([torch.stack(list(fi)).reshape(3, -1), ft.reshape(1, -1)])
        same = bool(torch.equal(fgot, want_all) and torch.equal(fgot, unforced))
        r_ms, ov_ms = round_ms(pc, lib, scene, rec.rec, 1.0, plan, dev)
        m_all, m_r, _, s_r = plan.counts.tolist()
        used = [r for r in plan.rounds.tolist() if r[1]]
        forced[name] = dict(capacity=cap, round_ms=r_ms, per_ray_ms=ov_ms, rounds_used=len(used),
                            per_ray_rays=m_all - m_r, per_ray_steps=hsteps - s_r,
                            tail_ms=sum(r_ms[1:]) + ov_ms)
        print(f"phase 5 replay at capacity {cap} ({name}): rounds with rays {len(used)} of "
              f"{len(r_ms)} (rays {[r[1] for r in used]}, steps {[r[3] for r in used]}), "
              f"{m_all - m_r} rays and {hsteps - s_r} steps to the per-ray kernel; round ms "
              f"{[round(x, 4) for x in r_ms]}, per-ray kernel {ov_ms:.4f} ms; past the first "
              f"round {forced[name]['tail_ms']:.4f} ms; (I, T) bitwise the plain replay and the "
              f"unforced replay {same}", flush=True)
        if not same:
            raise AssertionError(f"the replay at capacity {cap} is not bitwise")
        if name == "a third" and len(used) < 3:
            raise AssertionError(f"a third of the steps ran {len(used)} rounds, not 3 or more")
    ms["replay_overflow"] = forced["one step"]["per_ray_ms"]
    errs["replay_overflow"] = max(errs["replay_overflow"], (unforced - want_all).abs().max().item())
    print(f"phase 5 per-ray kernel at a step list of 1 step: {ov_sel.numel()} of "
          f"{horder.numel()} rays, {overflow_work[0]} steps; kernel {ms['replay_overflow']:.3f} ms, "
          f"plain {ov_plain_ms:.1f} ms; on the main path (every ray in round 0) its launch "
          f"{pass_ms['replay_overflow']:.4f} ms; at half the steps the tail through the rounds "
          f"{forced['half']['tail_ms']:.4f} ms", flush=True)

    # the same frame through the plain versions, on the card, stage by stage
    t_start = time.perf_counter()
    rec_p, plain_ms_rec = sync_ms(lambda: pc._record_plain(*hargs))
    order_p = pc.replay_order(rec_p.total).long()
    ip = torch.zeros((3, hh * hw), device=dev)
    tp = torch.ones(hh * hw, device=dev)
    (ip_sel, tp_sel), plain_ms_rep = sync_ms(
        lambda: pc._replay_plain(scene, rec_p.rec, 1.0, order_p))
    ip[:, order_p], tp[order_p] = ip_sel, tp_sel
    masked_p = rec_p.hit > 0.5
    bg_p, plain_ms_sky = sync_ms(lambda: ps._sky_plain(head_sky, rec_p.idx, rec_p.fx,
                                                       rec_p.fy, eff, masked_p))
    tp = torch.where(masked_p, 0.0, tp.reshape(hh, hw))
    hdr = Vec3(*(ip[c].reshape(hh, hw) + bg_p[c] * tp for c in range(3)))
    uvx, uvy = uv_planes(hw, hh, eff, dev)
    plain = pack_rgba8(apply_effects_and_tonemap(hdr, uvx, uvy, eff, scene.exposure))
    torch.cuda.synchronize()
    plain_frame_ms = (time.perf_counter() - t_start) * 1000.0
    plain_ms = {"record": plain_ms_rec, "replay": plain_ms_rep, "sky": plain_ms_sky,
                "replay_overflow": ov_plain_ms}

    head_hit_mis = (masked_p != masked).float().mean().item()
    same = ~(masked_p ^ masked)
    errs["record"] = max(errs["record"], (rec.fx - rec_p.fx)[:, same].abs().max().item(),
                         (rec.fy - rec_p.fy)[:, same].abs().max().item())
    got_it = torch.stack([inten.x, inten.y, inten.z]).reshape(3, -1)
    errs["replay"] = max(errs["replay"], (got_it - ip).abs().max().item())
    bgk = torch.stack(list(bg))
    errs["sky"] = max(errs["sky"], (bgk - bg_p)[:, ~(masked | masked_p)].abs().max().item())
    frame_np = frame.cpu().numpy()
    head_rmse = rmse(frame_np, plain.cpu().numpy())
    ok_frame = frame_np.shape == (hh, hw, 4) and frame_np.dtype == np.uint8
    print(f"phase 5 headline {hw}x{hh} ({smi}): latency "
          f"{[round(x, 3) for x in lat]} ms, throughput {thr:.3f} ms/frame; "
          f"plain path {plain_frame_ms:.0f} ms; RMSE kernels vs plain {head_rmse:.3g}; "
          f"record hit mismatch {head_hit_mis:.2e}; replayed rays {horder.numel()}; "
          f"launches {launches} (replay kernels {pass_launches}); peak {peak / 2**20:.0f} MiB",
          flush=True)
    for name in launches:
        print(f"  {name}: kernel {ms[name]:.3f} ms, plain {plain_ms[name]:.1f} ms")
    print(f"  replay bookkeeping on the device (replay_plan: sort of {hw * hh} keys, offsets, "
          f"the rounds kernel): {plan_ms:.3f} ms; replay kernels (CUDA events; the passes in "
          f"round 0): " + ", ".join(f"{k} {v:.4f} ms" for k, v in pass_ms.items())
          + f"; the {hrounds - 1} empty rounds ({4 * (hrounds - 1)} launches) {empty_ms:.4f} ms; "
          f"replay stage (plan, {hrounds} rounds, per-ray kernel) {stage_ms[hrounds]:.4f} ms, "
          f"with its plan cut to one round {stage_ms[1]:.4f} ms; step list: capacity {hcap} "
          f"entries, {list_bytes / 2**20:.1f} MiB ({list_bytes} B), holding {hsteps} steps; "
          f"{replay_shape}", flush=True)
    if not ok_frame:
        raise AssertionError(f"bad frame {frame_np.shape} {frame_np.dtype}")
    if not head_rmse < 1e-3:
        raise AssertionError(f"headline frame vs plain path: RMSE {head_rmse}")
    if min(launches.values()) < 1 or min(pass_launches.values()) < 1:
        raise AssertionError(f"a kernel of the frame path never launched: {lib.launches}")
    if launches["replay_overflow"] != 1 or launches["sky"] != 1:
        raise AssertionError(f"the compact frame's per-frame kernels: {lib.launches}")
    if pass_launches["replay_rounds"] != 1 or any(
            pass_launches[k] != hrounds for k in ("replay_march", "replay_shade_disk",
                                                  "replay_shade_cloud", "replay_composite")):
        raise AssertionError(f"the compact frame's replay ran other than {hrounds} rounds: "
                             f"{pass_launches}")

    # the inline frame (march_sky), against the compact frame
    inline_settings = RenderSettings(width=hw, height=hh, media_pass="inline")
    inline = Renderer(scene, inline_settings, skybox=head_sky, device=dev)
    inline.render(hcam, eff, 1.0)  # warm-up
    torch.cuda.synchronize()
    lib.reset_launches()
    inline_frame = inline.render(hcam, eff, 1.0)
    torch.cuda.synchronize()
    launches["march_sky"] = lib.launches["march_sky"]
    inline_sky_launches = lib.launches["sky"]
    inline_np = inline_frame.cpu().numpy()
    lat_i = [sync_ms(lambda i=i: inline.render(hcam, eff, 1.0 + i / 24.0))[1]
             for i in range(5)]
    _, thr_i = sync_ms(lambda: [inline.render(hcam, eff, 10.0 + i / 24.0) for i in range(5)])
    inline_rmse = rmse(inline_np, frame_np)
    print(f"phase 5 inline headline {hw}x{hh} ({smi}): latency "
          f"{[round(x, 3) for x in lat_i]} ms, throughput {thr_i / 5:.3f} ms/frame; RMSE vs "
          f"compact frame {inline_rmse:.3g} (bitwise {np.array_equal(inline_np, frame_np)}); "
          f"launches {lib.launches}", flush=True)
    if not (inline_rmse < 1e-3 and launches["march_sky"] >= 1 and inline_sky_launches == 1):
        raise AssertionError(f"inline headline frame: RMSE {inline_rmse}, {lib.launches}")

    # the no-sky frame (march_camera)
    nosky = Renderer(scene, settings, device=dev)
    nosky.render(hcam, eff, 1.0)
    torch.cuda.synchronize()
    lib.reset_launches()
    nosky_np = nosky.render(hcam, eff, 1.0).cpu().numpy()
    launches["march_camera"] = lib.launches["march_camera"]
    lat_n = [sync_ms(lambda: nosky.render(hcam, eff, 1.0))[1] for _ in range(3)]
    print(f"phase 5 no-sky headline: latency {[round(x, 3) for x in lat_n]} ms; frame "
          f"{nosky_np.shape} max {int(nosky_np[..., :3].max())}; launches {lib.launches}",
          flush=True)
    if not (launches["march_camera"] >= 1 and nosky_np.shape == (hh, hw, 4)):
        raise AssertionError(f"no-sky headline frame: {lib.launches}")

    # the headline pose at 4K and 8K through the compact program: its step
    # list stays within the budget; bitwise the inline frame
    big_frames = {}
    for bw, bh in ((3840, 2160), (7680, 4320)):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        big = Renderer(scene, RenderSettings(width=bw, height=bh), skybox=head_sky, device=dev)
        lib.reset_launches()
        big_c, first_ms = sync_ms(lambda: big.render(hcam, eff, 1.0))
        big_launches = {k: v for k, v in lib.launches.items() if v}
        big_peak = torch.cuda.max_memory_allocated(dev)
        _, big_ms = sync_ms(lambda: big.render(hcam, eff, 1.0), reps=2)
        big_i = Renderer(scene, RenderSettings(width=bw, height=bh, media_pass="inline"),
                         skybox=head_sky, device=dev)
        big_i_frame, _ = sync_ms(lambda: big_i.render(hcam, eff, 1.0))
        _, big_i_ms = sync_ms(lambda: big_i.render(hcam, eff, 1.0), reps=2)
        equal = bool(torch.equal(big_c, big_i_frame))
        big_rec = pc._record_cuda(scene, hscal, bw, bh, scene.max_steps, pc.SLOTS,
                                  *head_sky.shape, dev, lib)
        big_cap = pc.step_capacity(bw * bh, scene.max_steps)
        big_rounds = pc.replay_rounds(bw * bh, scene.max_steps, big_cap)
        big_plan = pc.replay_plan(big_rec.total, big_cap, rounds=big_rounds, lib=lib)
        m_b, m_rb, s_b, _ = big_plan.counts.tolist()
        used_b = int((big_plan.rounds[:, 1] > 0).sum())
        del big_rec, big_plan
        big_frames[f"{bw}x{bh}"] = dict(compact_ms=big_ms, inline_ms=big_i_ms,
                                        list_bytes=big_cap * 40, peak_bytes=big_peak,
                                        bitwise=equal)
        print(f"phase 5 headline pose at {bw}x{bh} ({smi}): compact {big_ms:.3f} ms a frame "
              f"(synchronized, mean of 2; first {first_ms:.1f} ms), inline {big_i_ms:.3f} ms; "
              f"bitwise the inline frame {equal}; step list {big_cap} entries = {big_cap * 40} B "
              f"({big_cap * 40 / 2**30:.2f} GiB); {s_b} steps of {m_b} rays in {used_b} of "
              f"{big_rounds} rounds, {m_b - m_rb} rays to the per-ray kernel; "
              f"max_memory_allocated {big_peak / 2**20:.0f} MiB ({(big_peak - base) / 2**20:.0f} "
              f"MiB over the {base / 2**20:.0f} MiB held before); launches {big_launches}",
              flush=True)
        if not equal or big_cap > pc.STEP_BUDGET:
            raise AssertionError(f"{bw}x{bh}: compact frame not bitwise inline ({equal}) or "
                                 f"list of {big_cap} entries")
        del big, big_i, big_c, big_i_frame
    torch.cuda.empty_cache()

    # kernel times of the fused march at the headline shapes
    steps_h = scene.max_steps
    ho, hd = rays_from_scalars(hscal, hw, hh, dev)
    k4 = pm._march_camera_sky_cuda(scene, hscal, hw, hh, steps_h, *head_sky.shape, dev, lib)
    k5 = pm._march_camera_cuda(scene, hscal, hw, hh, steps_h, dev, lib)
    k6 = pm._march_planes_cuda(scene, ho, hd, 1.0, steps_h, lib)
    same_it = all(torch.equal(torch.stack(list(a[0]) + [a[1]]), torch.stack(list(k4[0]) + [k4[1]]))
                  for a in (k5, k6))
    ms["march_sky"] = event_ms(lambda: pm._march_camera_sky_cuda(
        scene, hscal, hw, hh, steps_h, *head_sky.shape, dev, lib))
    ms["march_camera"] = event_ms(lambda: pm._march_camera_cuda(
        scene, hscal, hw, hh, steps_h, dev, lib))
    ms["march_planes"] = event_ms(lambda: pm._march_planes_cuda(scene, ho, hd, 1.0, steps_h,
                                                                lib))
    # the inline frame's background: the sky kernel without a mask
    ms_sky_inline = event_ms(lambda: ps.sky_background_windowed(head_sky, k4[2], k4[3], k4[4],
                                                                eff, lib=lib))
    # the same trajectories with no medium (the step sizes follow the zones
    # alone): the difference is what the inline shading costs
    vacuum = dataclasses.replace(scene, enable_disk=False, enable_clouds=False)
    ms_vacuum = event_ms(lambda: pm._march_camera_sky_cuda(
        vacuum, hscal, hw, hh, steps_h, *head_sky.shape, dev, lib))

    # one plain march (march_sky's plain version) on the headline rays: the
    # plain time of the three march kernels, and this frame's ray-step
    # counts, which size the bounds
    with StepCounter(dev) as counter:
        p4, plain_march_ms = sync_ms(lambda: pm._march_camera_sky_plain(
            scene, hscal, hw, hh, steps_h, *head_sky.shape, dev))
    n_steps, n_disk, n_cloud = counter.counts()
    per_ray_all = counter.per_ray.reshape(3, hh, hw).cpu().numpy()
    per_ray = per_ray_all[0]
    # a persistent grid of the record kernel's residency: 4 blocks of 256
    # threads an SM at its 56 registers
    lanes = torch.cuda.get_device_properties(dev).multi_processor_count * 1024
    simt = {"16x2": simt_efficiency(per_ray, 16, 2), "8x4": simt_efficiency(per_ray, 8, 4),
            f"ideal refill ({lanes} lanes)": refill_efficiency(per_ray, lanes)}
    if per_ray_all.sum(axis=(1, 2)).tolist() != [n_steps, n_disk, n_cloud]:
        raise AssertionError(f"per-ray counts {per_ray_all.sum(axis=(1, 2))} != "
                             f"{[n_steps, n_disk, n_cloud]}")
    errs["march_sky"] = max(errs["march_sky"], march_errs(k4, p4, True)[1])
    for name in ("march_sky", "march_camera", "march_planes"):
        plain_ms[name] = plain_march_ms
    print(f"phase 5 fused march at {hw}x{hh}: march_sky {ms['march_sky']:.3f} ms, "
          f"march_camera {ms['march_camera']:.3f} ms, march_planes {ms['march_planes']:.3f} ms "
          f"(CUDA events); the inline frame's sky kernel (no mask) {ms_sky_inline:.4f} ms; "
          f"march_sky with no medium (the same trajectories) {ms_vacuum:.3f} "
          f"ms, so the inline shading costs {ms['march_sky'] - ms_vacuum:.3f} ms; (I, T) of the "
          f"three equal {same_it}; plain march "
          f"{plain_march_ms:.1f} ms with {n_steps} ray-steps "
          f"({n_steps / (hw * hh):.1f} per ray), {n_disk} disk-probe and {n_cloud} "
          f"cloud-probe steps; record SIMT efficiency (steps / 32 x warp's longest): "
          + ", ".join(f"{k} {v:.4f}" for k, v in simt.items()), flush=True)
    if not same_it:
        raise AssertionError("the three march kernels disagree on (I, T)")

    # bounds: the larger of fp32 ops at 67 TFLOP/s and bytes at 3.35 TB/s
    npx = hw * hh
    # sky: per pixel 12 bytes of G-plane coordinates, a mask byte and 12 of
    # colour; each 16-byte quad the unmasked pixels touch, once (neighbouring
    # escape directions share quads)
    n_quads = int(torch.unique(rec.idx[1][~masked]).numel())
    sky_bytes = npx * (13 + 12) + n_quads * 16
    n_replay = float(rec.total.sum())
    shade_ops = n_disk * DISK_OPS + n_cloud * CLOUD_OPS
    bounds = {
        "record": bound(n_steps * VAC_OPS, npx * 4 * (11 + 7 * pc.SLOTS + 1)),
        "replay": bound(n_replay * VAC_OPS + shade_ops,
                        horder.numel() * (4 * 7 * pc.SLOTS + 4 + 16)),
        "sky": bound(npx * 36, sky_bytes),
        "replay_overflow": bound(overflow_work[0] * VAC_OPS + overflow_work[1] * DISK_OPS
                                 + overflow_work[2] * CLOUD_OPS, overflow_work[3]),
        "march_sky": bound(n_steps * VAC_OPS + shade_ops, npx * 52),
        "march_camera": bound(n_steps * VAC_OPS + shade_ops, npx * 32),
        "march_planes": bound(n_steps * VAC_OPS + shade_ops, npx * (24 + 32)),
    }
    for name, (b_ms, b_by) in bounds.items():
        print(f"  {name}: kernel {ms[name]:.3f} ms, bound {b_ms:.3f} ms ({b_by}), "
              f"plain {plain_ms[name]:.1f} ms")
    print(f"  sky bytes: {npx} pixels x 25 B, {n_quads} distinct quads x 16 B", flush=True)

    # the replay's traffic on the default paths, each second, at the cinema,
    # native and realtime sizes: steps a pixel, the rounds each frame uses,
    # the rays left to the per-ray kernel, and each replay bitwise one list
    # that holds every step
    t0 = time.perf_counter()
    traffic = replay_traffic.survey(every=1.0, lib=lib)
    traffic_totals = replay_traffic.totals(traffic)
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    (ROOT / "chiprun_out" / "replay_traffic.json").write_text(
        json.dumps(dict(device=kind, power=smi, every=1.0, rows=traffic, totals=traffic_totals),
                   indent=1))
    print(f"phase 5 replay traffic ({len(traffic)} frames, {time.perf_counter() - t0:.1f} s; "
          f"step list budget {pc.STEP_BUDGET} entries, at most {pc.ROUNDS} rounds; "
          f"chiprun_out/replay_traffic.json):", flush=True)
    for line in replay_traffic.summary(traffic):
        print("  " + line, flush=True)
    print("  totals by size (frames denser than 64 steps a pixel: replay ms summed against one "
          f"list's): {json.dumps(traffic_totals)}", flush=True)
    if not all(r["bitwise"] for r in traffic):
        raise AssertionError("a replay in rounds differs from one list's")

    # ---- phase 6: FMA contraction A/B
    t0 = time.perf_counter()
    lib_fma = cuda_lib.kernels(fmad=True)
    build_fma = time.perf_counter() - t0

    def fma_frame():
        return pc.render_frame_pallas_compact(scene, settings, hcam, eff, 1.0, head_sky,
                                              device=dev, lib=lib_fma)

    fma_frame()
    fma_img, fma_ms = sync_ms(fma_frame, reps=5)
    _, nofma_ms = sync_ms(lambda: renderer.render(hcam, eff, 1.0), reps=5)
    print(f"phase 6 -fmad A/B: contracted build {build_fma:.1f} s; frame RMSE vs "
          f"-fmad=false {rmse(fma_img.cpu().numpy(), frame_np):.3g}; "
          f"{fma_ms:.3f} ms/frame contracted vs {nofma_ms:.3f} ms/frame -fmad=false",
          flush=True)

    # ---- phase 8: shards on one card, one after another
    mesh = sharding.make_mesh([dev] * 8, (4, 2))
    ny_nx = mesh.devices.size
    for label, sset, whole_np, kernels in (
        ("compact, interleave auto", settings, frame_np, ("record",) + REPLAY_PASSES + ("sky",)),
        ("inline", inline_settings, inline_np, ("march_planes", "sky")),
    ):
        fn = sharding.make_sharded_renderer(scene, sset, mesh)
        fn(hcam, eff, 1.0, head_sky)  # warm-up
        torch.cuda.synchronize()
        lib.reset_launches()
        tiled = fn.reassemble(fn(hcam, eff, 1.0, head_sky))
        shard_launches = dict(lib.launches)
        interleave = sharding.resolve_interleave(scene, sset, "auto")
        programs = sharding._shard_programs(scene, sset, mesh, hcam, eff, 1.0, head_sky,
                                            interleave)
        shard_ms = [sync_ms(program)[1] for _, _, program in programs]
        equal = np.array_equal(tiled, whole_np)
        kernel_ms = ""
        if label == "inline":  # each shard's march_planes launch, by CUDA events
            per_launch = shard_launch_ms(lib, "march_planes", fn, hcam, eff, head_sky, reps=3)
            kernel_ms = (f"; march_planes per launch {[round(x, 3) for x in per_launch]} ms "
                         f"(sum {sum(per_launch):.3f})")
            inline_grid = fn
        else:  # each shard's record launch; the grid enqueued without a host sync
            shard_record_ms = shard_launch_ms(lib, "record", fn, hcam, eff, head_sky, reps=3)
            line, grid_syncs, _, grid_pending, _, _ = trace_frame(
                lambda: fn(hcam, eff, 1.0, head_sky), "shards_compact")
            kernel_ms = (f"; record per launch {[round(x, 3) for x in shard_record_ms]} ms "
                         f"(sum {sum(shard_record_ms):.3f}, one full-frame record "
                         f"{ms['record']:.3f}); traced grid: cudaStreamSynchronize {grid_syncs}, "
                         f"device work pending when the grid returned {grid_pending}")
            if grid_syncs:
                raise AssertionError(f"compact shard grid: {grid_syncs} cudaStreamSynchronize")
        print(f"phase 8 shards 4x2 on one card ({label}; shards run one after another on "
              f"{kind}): bitwise the single-device frame {equal}; shard ms "
              f"{[round(x, 3) for x in shard_ms]} (max {max(shard_ms):.3f}, sum "
              f"{sum(shard_ms):.3f}){kernel_ms}; launches {shard_launches}", flush=True)
        if not equal or min(shard_launches[k] for k in kernels) < 1:
            raise AssertionError(f"sharded frame ({label}) failed: {shard_launches}")
        if label == "inline":
            launches["march_planes"] = shard_launches["march_planes"]
            if shard_launches["sky"] != ny_nx:
                raise AssertionError(f"inline shard grid: {shard_launches['sky']} sky launches, "
                                     f"expected one a shard ({ny_nx})")

    # each inline shard's ray-steps and bound beside its march_planes launch
    ny, nx = mesh.shape
    sth, stw = hh // ny, hw // nx
    shard_bounds, shard_steps = [], []
    for k in range(ny * nx):
        i, j = divmod(k, nx)
        c = per_ray_all[:, i * sth:(i + 1) * sth, j * stw:(j + 1) * stw].sum(axis=(1, 2))
        shard_steps.append(int(c[0]))
        shard_bounds.append(bound(int(c[0]) * VAC_OPS + int(c[1]) * DISK_OPS
                                  + int(c[2]) * CLOUD_OPS, sth * stw * (24 + 32))[0])
    for k, (st, b_ms, l_ms) in enumerate(zip(shard_steps, shard_bounds, per_launch)):
        print(f"  shard {divmod(k, nx)}: {st} ray-steps ({st / n_steps:.4f} of the frame's), "
              f"bound {b_ms:.3f} ms, march_planes {l_ms:.3f} ms ({b_ms / l_ms:.3f} of bound)")
    # the inline shards' sky: the sky kernel on each tile's coordinates
    # (sharding.tile_background), beside the torch gather it replaced
    # (sample_sky_fast on the tile's directions), on the same velocities;
    # device ms on a held stream (event_ms)
    kernel_ms, tile_ms, old_ms = [], [], []
    for k in range(ny * nx):
        vel = march_shard(lib, scene, ho, hd, k, ny, nx, steps_h, dev)[3]
        new_bg = sharding.tile_background(head_sky, vel, eff)
        old_bg = sample_sky_fast(head_sky, normalize(vel), eff)
        if not all(torch.equal(a, b) for a, b in zip(new_bg, old_bg)):
            raise AssertionError(f"shard {divmod(k, nx)}: tile_background != sample_sky_fast")
        coords = sky_coords(normalize(vel), eff.ca_offset(), *head_sky.shape)
        sidx, sfx, sfy = (torch.stack(planes) for planes in zip(*coords))
        kernel_ms.append(event_ms(lambda: ps.sky_background_windowed(head_sky, sidx, sfx, sfy,
                                                                     eff)))
        tile_ms.append(event_ms(lambda: sharding.tile_background(head_sky, vel, eff)))
        old_ms.append(event_ms(lambda: sample_sky_fast(head_sky, normalize(vel), eff)))
    _, _, grid_names, _, grid_ops, grid_launches = trace_frame(
        lambda: inline_grid(hcam, eff, 1.0, head_sky), "shards_inline", lib)
    grid_gathers = torch_gathers_in(grid_names)
    # the whole inline grid, synchronized, with the sky kernel and with the
    # torch gather path put back (sharding.tile_background swapped), in turns
    new_tile_background = sharding.tile_background
    grid_ab = {"sky kernel": [], "torch gather": []}
    try:
        for turn in ("sky kernel", "torch gather", "torch gather", "sky kernel") * 5:
            sharding.tile_background = (new_tile_background if turn == "sky kernel" else
                                        lambda sky, vel, e: sample_sky_fast(sky, normalize(vel), e))
            grid_ab[turn].append(sync_ms(lambda: inline_grid(hcam, eff, 1.0, head_sky))[1])
    finally:
        sharding.tile_background = new_tile_background
    med = {k: float(np.median(v)) for k, v in grid_ab.items()}
    print(f"phase 8 inline shards' sky: {grid_launches['sky']} sky launches in the traced grid "
          f"(count), sky in its device trace {grid_names.get('sky', 0.0):.4f} ms, torch gathers "
          f"on the device {grid_gathers}, as host ops {grid_ops}; sky kernel per shard "
          f"{[round(x, 4) for x in kernel_ms]} ms (sum {sum(kernel_ms):.4f}, held stream); "
          f"coordinates + sky kernel (tile_background) summed {sum(tile_ms):.4f} ms against the "
          f"torch gather path it replaced (sample_sky_fast) summed {sum(old_ms):.4f} ms, "
          f"bitwise equal; the inline grid synchronized, 10 turns each: sky kernel median "
          f"{med['sky kernel']:.3f} ms {[round(x, 3) for x in grid_ab['sky kernel']]}, torch "
          f"gather median {med['torch gather']:.3f} ms "
          f"{[round(x, 3) for x in grid_ab['torch gather']]}; device ms by kernel in the traced "
          f"grid: " + "; ".join(f"{k} {v:.3f}" for k, v in
                               sorted(grid_names.items(), key=lambda kv: -kv[1])[:6]),
          flush=True)
    if grid_gathers or grid_ops or grid_launches["sky"] != ny_nx:
        raise AssertionError(f"inline shard grid: sky launches {grid_launches['sky']}, torch "
                             f"gathers {grid_gathers} {grid_ops}")
    ms_full_planes = ms["march_planes"]
    ms["march_planes"] = sum(per_launch)
    bounds["march_planes"] = (sum(shard_bounds), "operations")
    print(f"  march_planes: 8 shard launches {ms['march_planes']:.3f} ms against their summed "
          f"bound {sum(shard_bounds):.3f} ms; one full-frame launch {ms_full_planes:.3f} ms",
          flush=True)

    # per-warp timelines from the measurement build: the slowest shard's
    # launch and the full frame's
    lib_tl = cuda_lib.kernels(timeline=True)
    full_warps = lib.attrs("march_planes", 32, dev)["blocks_per_sm"]
    tl_buf = torch.zeros((cuda_lib.tile_count(hw, hh), 3), dtype=torch.int64, device=dev)
    lib_tl.set_timeline(tl_buf)
    slow = int(np.argmax(per_launch))
    tl_lines = []
    for what, run in (
        (f"slowest shard {divmod(slow, nx)}", lambda: march_shard(lib_tl, scene, ho, hd, slow, ny,
                                                                   nx, steps_h, dev)),
        ("full frame march_sky", lambda: pm._march_camera_sky_cuda(
            scene, hscal, hw, hh, steps_h, *head_sky.shape, dev, lib_tl)),
    ):
        run()  # warm-up
        tl_buf.zero_()
        run()
        torch.cuda.synchronize()
        tl = tl_buf.cpu().numpy()
        tl = tl[tl[:, 2] > 0]
        tl_lines.append(f"{what}: {timeline_summary(tl, n_sms, full_warps)}")
    print("phase 8 march timeline (measurement build, per warp): " + "; ".join(tl_lines),
          flush=True)

    order_ab(lib, scene, hscal, ho, hd, head_sky, per_ray_all, steps_h, dev)

    # ---- phase 7: one compact and one inline frame under torch.profiler
    line, syncs, compact_names, pending, _, _ = trace_frame(
        lambda: renderer.render(hcam, eff, 1.0), "headline")
    print(line, flush=True)
    line, _, inline_names, _, inline_ops, inline_launches = trace_frame(
        lambda: inline.render(hcam, eff, 1.0), "inline", lib)
    print(line, flush=True)
    if not compact_names or not inline_names:  # the checks below read the device events
        raise AssertionError("phase 7: the profiler recorded no device events")
    if syncs != 0 or not pending:
        raise AssertionError(f"compact frame: {syncs} cudaStreamSynchronize, device work "
                             f"pending when render returned {pending}")
    # torch's gathers: advanced indexing and index_select / gather, as device
    # kernels and as host ops. The traced frame's sky launch is read from the
    # wrapper's count: CUPTI's record of a kernel is not guaranteed to reach
    # the trace, the count is made where the kernel is launched.
    torch_gathers = torch_gathers_in(inline_names)
    print(f"phase 7 inline frame: sky launches {inline_launches['sky']} (count), sky in the "
          f"device trace {'sky' in inline_names}; torch gathers on the device {torch_gathers}, "
          f"as host ops {inline_ops}", flush=True)
    if torch_gathers or inline_ops or inline_launches["sky"] != 1:
        raise AssertionError(f"inline frame: sky launches {inline_launches['sky']}, torch "
                             f"gathers {torch_gathers} {inline_ops}; device trace "
                             f"{sorted(inline_names)}")

    # ---- phase 10: the probes, and each frame kernel's measured floor
    t_phase = time.perf_counter()
    probe_rows, floors, tail_floor = phase10_probes(
        lib, dev, n_sms, (n_steps, n_disk, n_cloud), n_replay,
        horder.numel() * (4 * 7 * pc.SLOTS + 4 + 16), sky_bytes, overflow_work, tail_work)
    for name, (f_ms, f_by, sass_ms) in floors.items():
        floor = f"measured floor {f_ms:.4f} ms ({f_by}; kernel at {f_ms / ms[name]:.3f} of it)"
        diag = "" if sass_ms is None else f", SASS shortest-iteration time {sass_ms:.3f} ms"
        print(f"  {name}: kernel {ms[name]:.4f} ms, {floor}{diag}, 67e12 bound "
              f"{bounds[name][0]:.4f} ms ({bounds[name][1]})", flush=True)
    half_tail = forced["half"]["tail_ms"]
    print(f"  the half-capacity tail through the rounds ({tail_work[0]} steps): "
          f"{half_tail:.4f} ms, measured floor {tail_floor:.4f} ms (at {tail_floor / half_tail:.3f} "
          f"of it)", flush=True)
    # the compact shard grid's 8 record launches do the full-frame record's work
    rec_floor = floors["record"][0]
    print(f"  compact shard grid: 8 record launches {sum(shard_record_ms):.3f} ms against the "
          f"frame's record floor {rec_floor:.3f} ms ({rec_floor / sum(shard_record_ms):.3f} of "
          f"it); launches x (time - floor) {sum(shard_record_ms) - rec_floor:.3f} ms",
          flush=True)

    print(f"phase 10 took {time.perf_counter() - t_phase:.1f} s", flush=True)

    # ---- phase 11: the host runtime at full width
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        phase11_runtime(lib, dev, {"compact": renderer, "inline": inline}, head_sky,
                        {"compact": thr, "inline": thr_i / 5}, pathlib.Path(tmp))
    print(f"phase 11 took {time.perf_counter() - t_phase:.1f} s", flush=True)

    # ---- phase 12: the graft entry, the dry run and the examples
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        phase12_entry_points(lib, dev, pathlib.Path(tmp))
    print(f"phase 12 took {time.perf_counter() - t_phase:.1f} s", flush=True)

    # ---- phase 13: the loop choice (kernel programs vs the plain march)
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        phase13_loop(lib, dev, head_sky, smi, pathlib.Path(tmp))
    print(f"phase 13 took {time.perf_counter() - t_phase:.1f} s", flush=True)

    rows = {name: dict(launches=launches[name], max_abs_err=errs[name], ms=ms[name],
                       plain_ms=plain_ms[name], bound_ms=bounds[name][0],
                       bound_by=bounds[name][1], library_ms=None,
                       floor_ms=floors[name][0], floor_by=floors[name][1],
                       sass_floor_ms=floors[name][2])
            for name in floors}
    rows["replay"].update(round0_passes_ms=sum(v for k, v in pass_ms.items()
                                               if k not in ("replay_rounds", "replay_overflow")),
                          rounds_kernel_ms=pass_ms["replay_rounds"], empty_rounds_ms=empty_ms,
                          rounds=hrounds, plan_ms=plan_ms, stage_ms=stage_ms[hrounds],
                          stage_one_round_ms=stage_ms[1])
    rows["replay_overflow"]["main_path_ms"] = pass_ms["replay_overflow"]
    rows["replay_overflow"]["forced"] = forced
    rows["replay_overflow"].update(half_tail_ms=half_tail, half_tail_floor_ms=tail_floor)
    rows["sky"]["inline_ms"] = ms_sky_inline
    rows["sky"]["inline_shards_ms"] = sum(kernel_ms)  # phase 8: 8 shard launches, held stream
    rows.update(probe_rows)
    rows["replay"]["big_frames"] = big_frames
    table = {"kernels": [dict(name=name, route="cuda", source=src, replaces=rep, **rows[name])
                         for name, (src, rep, _) in KERNELS.items()]}
    print(f"chip_smoke took {time.perf_counter() - t_main:.1f} s", flush=True)
    print(json.dumps(table))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
