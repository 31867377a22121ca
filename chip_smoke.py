#!/usr/bin/env python3
"""Drive the PyTorch port's frame paths on one CUDA card.

    python3 chip_smoke.py

Phases, one printed line (or block) each; any failure raises and the
script exits non-zero without the final result line:

  1. device: torch's device name and `nvidia-smi` name + power limit;
  2. build: nvcc builds csrc/*.cu (record, replay, sky, march), one process
     per source started together, for sm_90a;
  3. kernels vs plain PyTorch on the card: record at 192x108 with 2000
     steps (hit mismatch < 1e-3, sky index equal where hit agrees), replay
     on that record (rtol 2e-6 / atol 5e-7), sky on random and smooth
     directions with chromatic aberration on and off (bitwise where
     unmasked), and the three fused march kernels (march_sky, march_camera,
     march_planes) at 192x108 with 2000 steps (hit mismatch < 1e-3, (I, T)
     and v or the sky coordinates to rtol 2e-6 / atol 5e-7 where hits
     agree, sky indices equal);
  4. the seven golden cases through Renderer(device="cuda"), RMSE < 1e-3
     each against tests/goldens/*.npy (the two vacuum cases run the fused
     march kernel, the rest record/replay/sky), and a no-sky 192x108 frame
     (march_camera) against the plain path on the card, RMSE < 1e-3;
  5. the headline frame (1920x1080, full scene, 2000 steps, start pose,
     2048x4096 starfield): latency and pipelined throughput, per-kernel
     times beside the plain versions', the frame against the plain path on
     the card (RMSE < 1e-3), launches of each kernel on the main path,
     replayed rays and peak memory; then the same frame with
     media_pass="inline" (march_sky: latency, throughput, RMSE against the
     compact frame), the no-sky frame (march_camera), march_planes on the
     headline rays, one plain march at 1080p (the plain time of the three
     march kernels, with its ray-step counts, which size the bounds);
  6. the -fmad=false vs contracted-FMA build A/B on the headline frame
     (informational; a build or launch failure still fails the run);
  7. with --trace only: one headline frame and one inline headline frame
     under torch.profiler — device time per kernel, device busy time
     against the frame's wall time — and their Chrome traces in
     chiprun_out/{headline,inline}_trace.json;
  8. shards on one card: the 1080p frame on a 4x2 grid of cuda:0, shards
     run one after another — the compact branch (strip-interleaved) and
     the inline branch (march_planes) — each bitwise the single-device
     frame after `reassemble`, with each shard's ms.

It then prints the kernel table as one JSON line (each kernel's launches
on its path, max error against its plain version, ms, plain ms, the bound
and what bounds it), the nvidia-smi line, and last {"ok": true,
"device": {...}}. It needs one CUDA card and imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
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

CSRC = "relativisticraytracer_tpu_torch/csrc/"
# name: (source, the TPU kernel it replaces, its __global__ symbol)
KERNELS = {
    "record": (CSRC + "record.cu", "relativisticraytracer_tpu/ops/pallas_compact.py:332",
               "record_kernel"),
    "replay": (CSRC + "replay.cu", "relativisticraytracer_tpu/ops/pallas_compact.py:560",
               "replay_kernel"),
    "sky": (CSRC + "sky.cu", "relativisticraytracer_tpu/ops/pallas_sky.py:189", "sky_kernel"),
    "march_sky": (CSRC + "march.cu", "relativisticraytracer_tpu/ops/pallas_march.py:543",
                  "march_camera_sky_kernel"),
    "march_camera": (CSRC + "march.cu", "relativisticraytracer_tpu/ops/pallas_march.py:416",
                     "march_camera_kernel"),
    "march_planes": (CSRC + "march.cu", "relativisticraytracer_tpu/ops/pallas_march.py:324",
                     "march_planes_kernel"),
}

# H100 SXM peaks (NVIDIA's data sheet): fp32 outside the tensor cores, HBM.
PEAK_F32 = 67e12
PEAK_BYTES = 3.35e12
# Float operations per ray-step, counted from csrc/march_common.cuh: one
# per add, multiply, compare, select or math-library call (a powf or expf
# counts one, so these undercount and the bound stays a lower bound).
VAC_OPS = 247      # zones, adaptive h, probes, RK4 (4 x geodesic_acc, 31 each), escape
DISK_OPS = 1475    # disk_block on a disk-probe step: 5-octave fbm (1,320) and the rest
CLOUD_OPS = 5220   # cloud_block on a cloud-probe step: 7 two-octave fbm + 5 ridge octaves


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


def event_ms(fn, reps: int = 5) -> float:
    """Mean device ms per call, by CUDA events, after one warm-up call."""
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(ops: float, nbytes: float):
    """(bound_ms, bound_by): the larger of the operations at the fp32 peak
    and the bytes at the HBM rate."""
    t_ops, t_bytes = ops / PEAK_F32, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1000.0, ("operations" if t_ops >= t_bytes else "bytes")


class StepCounter:
    """Counts, on the card and without host syncs, what a plain march
    (render/march.march) does: ray-steps (rays active when a step starts),
    and steps whose disk or cloud probe is True. It wraps render/march's
    march_step and _media_contribution while it is entered."""

    def __init__(self, device):
        self.n = torch.zeros(3, dtype=torch.int64, device=device)

    def __enter__(self):
        from relativisticraytracer_tpu_torch.render import march as rm

        self._rm = rm
        self._orig = step, media = rm.march_step, rm._media_contribution

        def counted_step(scene, st, time, media_hook=None):
            self.n[0] += st.active.sum()
            return step(scene, st, time, media_hook)

        def counted_media(*args, probe_disk=None, probe_cloud=None):
            for k, probe in ((1, probe_disk), (2, probe_cloud)):
                if probe is not None:
                    self.n[k] += probe.sum()
            return media(*args, probe_disk=probe_disk, probe_cloud=probe_cloud)

        rm.march_step, rm._media_contribution = counted_step, counted_media
        return self

    def __exit__(self, *exc):
        self._rm.march_step, self._rm._media_contribution = self._orig

    def counts(self):
        return [int(c) for c in self.n.tolist()]


def trace_frame(render, label: str) -> str:
    """One warm call of `render` under torch.profiler: a summary line of
    device time by kernel and device busy time against wall time. The
    Chrome trace goes to chiprun_out/<label>_trace.json."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    render()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        render()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1000.0
    out = ROOT / "chiprun_out" / f"{label}_trace.json"
    out.parent.mkdir(exist_ok=True)
    prof.export_chrome_trace(str(out))
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events() if e.device_type == DeviceType.CUDA)
    if not spans:
        return (f"phase 7 trace ({label}): frame wall {wall_ms:.3f} ms; the profiler recorded "
                f"no device events (device time not measured)")
    busy_us, end_us = 0.0, spans[0][0]
    by_name = {}
    for s, e, name in spans:
        busy_us += max(0.0, e - max(s, end_us))  # union of the device intervals
        end_us = max(end_us, e)
        symbol = name.split("(")[0].split(" ")[-1]
        key = next((k for k, v in KERNELS.items() if v[2] == symbol), "other: " + name[:60])
        by_name[key] = by_name.get(key, 0.0) + (e - s) / 1000.0
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    return (f"phase 7 trace (torch.profiler, one {label} frame): wall {wall_ms:.3f} ms, "
            f"device busy {busy_us / 1000.0:.3f} ms (idle share "
            f"{1.0 - busy_us / 1000.0 / wall_ms:.3f}), device span "
            f"{(end_us - spans[0][0]) / 1000.0:.3f} ms, {len(spans)} device events; "
            f"device ms by kernel: " + "; ".join(f"{k} {v:.3f}" for k, v in top))


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--trace", action="store_true",
                        help="also trace the headline and inline frames with torch.profiler")
    opts = parser.parse_args()
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
    from relativisticraytracer_tpu_torch.ops import pallas_compact as pc
    from relativisticraytracer_tpu_torch.ops import pallas_march as pm
    from relativisticraytracer_tpu_torch.ops import pallas_sky as ps
    from relativisticraytracer_tpu_torch.ops.camera_rays import rays_from_scalars
    from relativisticraytracer_tpu_torch.parallel import sharding
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
        sky_coords,
        skybox_from_array,
    )

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
    for line in lib.build_log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}")
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

    order = pc.replay_order(rk.total)
    ik, tk = pc.media_replay(scene, rk.rec, t, order=order, lib=lib)
    ip = torch.zeros((3, h * w), device=dev)
    tp = torch.ones(h * w, device=dev)
    sel = order.long()
    ip[:, sel], tp[sel] = pc._replay_plain(scene, rk.rec, t, sel)
    got = torch.stack([ik.x, ik.y, ik.z, tk]).reshape(4, -1)
    want = torch.cat([ip, tp[None]])
    torch.testing.assert_close(got, want, rtol=2e-6, atol=5e-7)
    errs["replay"] = (got - want).abs().max().item()
    print(f"phase 3 replay {order.numel()} rays: max |d(I,T)| {errs['replay']:.3g} "
          f"(rtol 2e-6, atol 5e-7)", flush=True)

    head_sky = skybox_from_array(procedural_starfield(2048, 4096, device=dev), dev)
    rng = np.random.default_rng(7)
    sky_err = 0.0
    for sky_name, sky in (("64x128", small_sky), ("2048x4096", head_sky)):
        n_side = (256, 512)
        v = rng.standard_normal((3,) + n_side).astype(np.float32)
        v /= np.linalg.norm(v, axis=0, keepdims=True)
        yy, xx = np.meshgrid(np.linspace(-0.4, 0.4, n_side[0]),
                             np.linspace(-0.7, 0.7, n_side[1]), indexing="ij")
        smooth = normalize(Vec3(*(torch.as_tensor(a, dtype=torch.float32, device=dev)
                                  for a in (xx, yy, np.ones_like(xx)))))
        rand = Vec3(*(torch.as_tensor(a, device=dev) for a in v))
        masked = torch.as_tensor(rng.random(n_side) < 0.3, device=dev)
        for dirs_name, d in (("random", rand), ("smooth", smooth)):
            for e in (effects_off(), CameraEffects(use_chromatic_aberration=1.0,
                                                   ca_amount=0.01)):
                coords = sky_coords(d, e.ca_offset(), *sky.shape)
                idx, fx, fy = (torch.stack([c[j] for c in coords]) for j in range(3))
                bk = ps.sky_background_windowed(sky, idx, fx, fy, e, masked, lib=lib)
                bp = ps._sky_plain(sky, idx, fx, fy, e, masked)
                bk = torch.stack(list(bk))
                if not torch.equal(bk[:, ~masked], bp[:, ~masked]):
                    raise AssertionError(f"sky kernel not bitwise ({sky_name}, {dirs_name})")
                if bool((bk[:, masked] != 0).any()):
                    raise AssertionError("sky kernel wrote a masked pixel")
                sky_err = max(sky_err, (bk - bp)[:, ~masked].abs().max().item())
    errs["sky"] = sky_err
    print("phase 3 sky: bitwise on unmasked pixels (2 skies x random/smooth x CA off/on)",
          flush=True)

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
        if ran != (["march_sky"] if vacuum else ["record", "replay", "sky"]):
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
    launches = {k: lib.launches[k] for k in ("record", "replay", "sky")}
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
    horder = pc.replay_order(rec.total)
    masked = rec.hit > 0.5
    inten, trans = pc.media_replay(scene, rec.rec, 1.0, order=horder, lib=lib)
    bg = ps.sky_background_windowed(head_sky, rec.idx, rec.fx, rec.fy, eff, masked,
                                    lib=lib)
    ms = {
        "record": event_ms(lambda: pc._record_cuda(*hargs, lib)),
        "replay": event_ms(lambda: pc.media_replay(scene, rec.rec, 1.0, order=horder,
                                                   lib=lib)),
        "sky": event_ms(lambda: ps.sky_background_windowed(head_sky, rec.idx, rec.fx,
                                                           rec.fy, eff, masked, lib=lib)),
    }

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
    plain_ms = {"record": plain_ms_rec, "replay": plain_ms_rep, "sky": plain_ms_sky}

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
          f"launches {launches}; peak {peak / 2**20:.0f} MiB", flush=True)
    for name in launches:
        print(f"  {name}: kernel {ms[name]:.3f} ms, plain {plain_ms[name]:.1f} ms")
    if not ok_frame:
        raise AssertionError(f"bad frame {frame_np.shape} {frame_np.dtype}")
    if not head_rmse < 1e-3:
        raise AssertionError(f"headline frame vs plain path: RMSE {head_rmse}")
    if min(launches.values()) < 1:
        raise AssertionError(f"a kernel of the frame path never launched: {launches}")

    # the inline frame (march_sky), against the compact frame
    inline_settings = RenderSettings(width=hw, height=hh, media_pass="inline")
    inline = Renderer(scene, inline_settings, skybox=head_sky, device=dev)
    inline.render(hcam, eff, 1.0)  # warm-up
    torch.cuda.synchronize()
    lib.reset_launches()
    inline_frame = inline.render(hcam, eff, 1.0)
    torch.cuda.synchronize()
    launches["march_sky"] = lib.launches["march_sky"]
    inline_np = inline_frame.cpu().numpy()
    lat_i = [sync_ms(lambda i=i: inline.render(hcam, eff, 1.0 + i / 24.0))[1]
             for i in range(5)]
    _, thr_i = sync_ms(lambda: [inline.render(hcam, eff, 10.0 + i / 24.0) for i in range(5)])
    inline_rmse = rmse(inline_np, frame_np)
    print(f"phase 5 inline headline {hw}x{hh} ({smi}): latency "
          f"{[round(x, 3) for x in lat_i]} ms, throughput {thr_i / 5:.3f} ms/frame; RMSE vs "
          f"compact frame {inline_rmse:.3g} (bitwise {np.array_equal(inline_np, frame_np)}); "
          f"launches {lib.launches}", flush=True)
    if not (inline_rmse < 1e-3 and launches["march_sky"] >= 1):
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

    # one plain march (march_sky's plain version) on the headline rays: the
    # plain time of the three march kernels, and this frame's ray-step
    # counts, which size the bounds
    with StepCounter(dev) as counter:
        p4, plain_march_ms = sync_ms(lambda: pm._march_camera_sky_plain(
            scene, hscal, hw, hh, steps_h, *head_sky.shape, dev))
    n_steps, n_disk, n_cloud = counter.counts()
    errs["march_sky"] = max(errs["march_sky"], march_errs(k4, p4, True)[1])
    for name in ("march_sky", "march_camera", "march_planes"):
        plain_ms[name] = plain_march_ms
    print(f"phase 5 fused march at {hw}x{hh}: march_sky {ms['march_sky']:.3f} ms, "
          f"march_camera {ms['march_camera']:.3f} ms, march_planes {ms['march_planes']:.3f} ms "
          f"(CUDA events); (I, T) of the three equal {same_it}; plain march "
          f"{plain_march_ms:.1f} ms with {n_steps} ray-steps "
          f"({n_steps / (hw * hh):.1f} per ray), {n_disk} disk-probe and {n_cloud} "
          f"cloud-probe steps", flush=True)
    if not same_it:
        raise AssertionError("the three march kernels disagree on (I, T)")

    # bounds: the larger of fp32 ops at 67 TFLOP/s and bytes at 3.35 TB/s
    npx = hw * hh
    n_replay = float(rec.total.sum())
    shade_ops = n_disk * DISK_OPS + n_cloud * CLOUD_OPS
    bounds = {
        "record": bound(n_steps * VAC_OPS, npx * 4 * (11 + 7 * pc.SLOTS + 1)),
        "replay": bound(n_replay * VAC_OPS + shade_ops,
                        horder.numel() * (4 * 7 * pc.SLOTS + 4 + 16)),
        "sky": bound(npx * 36, npx * (13 + 12) + int((~masked).sum()) * 16),
        "march_sky": bound(n_steps * VAC_OPS + shade_ops, npx * 52),
        "march_camera": bound(n_steps * VAC_OPS + shade_ops, npx * 32),
        "march_planes": bound(n_steps * VAC_OPS + shade_ops, npx * (24 + 32)),
    }
    for name, (b_ms, b_by) in bounds.items():
        print(f"  {name}: kernel {ms[name]:.3f} ms, bound {b_ms:.3f} ms ({b_by}), "
              f"plain {plain_ms[name]:.1f} ms")

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
    for label, sset, whole_np, kernels in (
        ("compact, interleave auto", settings, frame_np, ("record", "replay", "sky")),
        ("inline", inline_settings, inline_np, ("march_planes",)),
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
        print(f"phase 8 shards 4x2 on one card ({label}; shards run one after another on "
              f"{kind}): bitwise the single-device frame {equal}; shard ms "
              f"{[round(x, 3) for x in shard_ms]} (max {max(shard_ms):.3f}, sum "
              f"{sum(shard_ms):.3f}); launches {shard_launches}", flush=True)
        if not equal or min(shard_launches[k] for k in kernels) < 1:
            raise AssertionError(f"sharded frame ({label}) failed: {shard_launches}")
        if label == "inline":
            launches["march_planes"] = shard_launches["march_planes"]

    if opts.trace:
        print(trace_frame(lambda: renderer.render(hcam, eff, 1.0), "headline"), flush=True)
        print(trace_frame(lambda: inline.render(hcam, eff, 1.0), "inline"), flush=True)

    table = {"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[name], "max_abs_err": errs[name],
         "ms": ms[name], "plain_ms": plain_ms[name], "bound_ms": bounds[name][0],
         "bound_by": bounds[name][1], "library_ms": None}
        for name, (src, rep, _) in KERNELS.items()
    ]}
    print(json.dumps(table))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
