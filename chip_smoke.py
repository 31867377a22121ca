#!/usr/bin/env python3
"""Drive the PyTorch port's default frame path on one CUDA card.

    python3 chip_smoke.py

Phases, one printed line (or block) each; any failure raises and the
script exits non-zero without the final result line:

  1. device: torch's device name and `nvidia-smi` name + power limit;
  2. build: nvcc builds csrc/*.cu (record, replay, sky) for sm_90a;
  3. kernels vs plain PyTorch on the card: record at 192x108 with 2000
     steps (hit mismatch < 1e-3, sky index equal where hit agrees), replay
     on that record (rtol 2e-6 / atol 5e-7), sky on random and smooth
     directions with chromatic aberration on and off (bitwise where
     unmasked);
  4. the seven golden cases through Renderer(device="cuda"), RMSE < 1e-3
     each against tests/goldens/*.npy;
  5. the headline frame (1920x1080, full scene, 2000 steps, start pose,
     2048x4096 starfield): latency and pipelined throughput, per-kernel
     times beside the plain versions', the frame against the plain path on
     the card (RMSE < 1e-3), launches of each kernel on the main path,
     replayed rays and peak memory;
  6. the -fmad=false vs contracted-FMA build A/B on the headline frame
     (informational; a build or launch failure still fails the run);
  7. with --trace only: one headline frame under torch.profiler — device
     time per kernel, device busy time against the frame's wall time —
     and its Chrome trace in chiprun_out/headline_trace.json.

It then prints the kernel table as one JSON line, the nvidia-smi line, and
last {"ok": true, "device": {...}}. It needs one CUDA card and imports no
JAX.
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

KERNELS = {
    "record": ("relativisticraytracer_tpu_torch/csrc/record.cu",
               "relativisticraytracer_tpu/ops/pallas_compact.py:332"),
    "replay": ("relativisticraytracer_tpu_torch/csrc/replay.cu",
               "relativisticraytracer_tpu/ops/pallas_compact.py:560"),
    "sky": ("relativisticraytracer_tpu_torch/csrc/sky.cu",
            "relativisticraytracer_tpu/ops/pallas_sky.py:189"),
}


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


def trace_frame(render) -> str:
    """One warm call of `render` under torch.profiler: a summary line of
    device time by kernel and device busy time against wall time. The
    Chrome trace goes to chiprun_out/headline_trace.json."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    render()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        render()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1000.0
    out = ROOT / "chiprun_out" / "headline_trace.json"
    out.parent.mkdir(exist_ok=True)
    prof.export_chrome_trace(str(out))
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events() if e.device_type == DeviceType.CUDA)
    if not spans:
        return (f"phase 7 trace: frame wall {wall_ms:.3f} ms; the profiler recorded "
                f"no device events (device time not measured)")
    busy_us, end_us = 0.0, spans[0][0]
    by_name = {}
    for s, e, name in spans:
        busy_us += max(0.0, e - max(s, end_us))  # union of the device intervals
        end_us = max(end_us, e)
        key = next((k for k in KERNELS if f"{k}_kernel" in name), "other: " + name[:60])
        by_name[key] = by_name.get(key, 0.0) + (e - s) / 1000.0
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    return (f"phase 7 trace (torch.profiler, one headline frame): wall {wall_ms:.3f} ms, "
            f"device busy {busy_us / 1000.0:.3f} ms (idle share "
            f"{1.0 - busy_us / 1000.0 / wall_ms:.3f}), device span "
            f"{(end_us - spans[0][0]) / 1000.0:.3f} ms, {len(spans)} device events; "
            f"device ms by kernel: " + "; ".join(f"{k} {v:.3f}" for k, v in top))


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--trace", action="store_true",
                        help="also trace one headline frame with torch.profiler")
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
    from relativisticraytracer_tpu_torch.ops import pallas_sky as ps
    from relativisticraytracer_tpu_torch.render.camera import (
        camera_state_from_pose,
        uv_planes,
    )
    from relativisticraytracer_tpu_torch.render.pipeline import Renderer
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

    # ---- phase 4: the golden cases through the renderer on the card
    sky_small_rgba = np.load(STARFIELD)
    worst = 0.0
    for name, kw, fx_on, (gw, gh), pose, gt, gsteps in GOLDEN_CASES:
        r = Renderer(SceneConfig(max_steps=gsteps, **kw),
                     RenderSettings(width=gw, height=gh, max_steps=gsteps),
                     skybox_rgba=sky_small_rgba, device=dev)
        got = r.render_np(camera_state_from_pose(*pose),
                          CameraEffects() if fx_on else effects_off(), gt)
        e = rmse(got, np.load(GOLDEN_DIR / f"{name}.npy"))
        worst = max(worst, e)
        print(f"phase 4 golden {name}: RMSE {e:.3g}", flush=True)
        if not e < 1e-3:
            raise AssertionError(f"golden {name}: RMSE {e} >= 1e-3")

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
    launches = dict(lib.launches)
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
    for name in KERNELS:
        print(f"  {name}: kernel {ms[name]:.3f} ms, plain {plain_ms[name]:.1f} ms")
    if not ok_frame:
        raise AssertionError(f"bad frame {frame_np.shape} {frame_np.dtype}")
    if not head_rmse < 1e-3:
        raise AssertionError(f"headline frame vs plain path: RMSE {head_rmse}")
    if min(launches.values()) < 1:
        raise AssertionError(f"a kernel of the frame path never launched: {launches}")

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
    if opts.trace:
        print(trace_frame(lambda: renderer.render(hcam, eff, 1.0)), flush=True)

    table = {"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[name], "max_abs_err": errs[name],
         "ms": ms[name], "plain_ms": plain_ms[name]}
        for name, (src, rep) in KERNELS.items()
    ]}
    print(json.dumps(table))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
