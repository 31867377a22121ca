"""Build, load and call the hand-written CUDA kernels (csrc/*.cu): the
frame kernels (record, replay, sky, march) and the measurement probes
(probes.cu).

The kernels are compiled at first use by `nvcc`, one process per source
started together, and linked into one shared library with a plain C
interface, loaded with ctypes. Pointers and the stream are
passed as `c_void_p`; every C entry returns `cudaGetLastError()` and the
wrappers raise when it is not 0. The build goes to `_build/` inside this
package (listed in .gitignore), keyed by a hash of the sources and flags,
and is compiled for `sm_90a` (Hopper).

Flags: `-fmad=false` keeps nvcc from contracting a*b+c into an FMA, so the
record, replay and fused march kernels march bitwise the same trajectory
and match the plain PyTorch versions; `--use_fast_math` is never used. `fmad=True`
builds the contracted variant for the A/B that measures what contraction
does to frames.

fp64: a bare literal such as `0.1031` is a double in C++ and would promote
the math to fp64 silently. The build keeps the PTX (`-keep`) and fails on
any fp64 instruction except the one the CUDA math library's sinf/cosf
carry in their Payne-Hanek reduction for |x| > 105615 (a 64-bit integer
times pi/2 * 2^-62, which the disk's rotation angle reaches only after
~30,000 s of simulated time). ptxas's --warn-on-double-precision-use
cannot tell that path from ours, so the PTX scan takes its place.

Nothing here runs at import: the tests import every module on machines
without a GPU or nvcc.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from relativisticraytracer_tpu_torch.config import SceneConfig
from relativisticraytracer_tpu_torch.core.vecmath import fdiv
from relativisticraytracer_tpu_torch.media.densities import (
    cloud_probe_bounds,
    disk_probe_bounds,
)

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
SOURCES = ("record.cu", "replay.cu", "sky.cu", "march.cu", "probes.cu")
HEADERS = ("march_common.cuh", "launch.cuh")
# A launcher's return when it had no work and launched nothing
# (csrc/launch.cuh RRT_NOT_LAUNCHED).
NOT_LAUNCHED = -1
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
BASE_FLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
# The fp64 instructions of the math library's sinf/cosf slow path (see the
# module docstring); every other fp64 instruction fails the build.
_TRIG_SLOW_PATH_F64 = re.compile(
    r"^\s*(cvt\.rn\.f64\.s64\s+%fd\d+, %rd\d+"
    r"|mul(\.rn)?\.f64\s+%fd\d+, %fd\d+, 0d3BF921FB54442D19"
    r"|cvt\.rn\.f32\.f64\s+%f\d+, %fd\d+);$")


def fp64_instructions(ptx: str):
    """PTX lines that compute in fp64, other than the trig slow path."""
    return [line.strip() for line in ptx.splitlines()
            if ".f64" in line and not line.lstrip().startswith(".reg")
            and not _TRIG_SLOW_PATH_F64.match(line)]


class SceneConsts(ctypes.Structure):
    """Mirror of `struct SceneConsts` in csrc/march_common.cuh (same order)."""

    _fields_ = [
        ("eh", ctypes.c_float), ("inside_r2", ctypes.c_float),
        ("radial_k", ctypes.c_float), ("spin_k", ctypes.c_float),
        ("spin_a", ctypes.c_float), ("spin_axis", ctypes.c_float * 3),
        ("mass_pos", ctypes.c_float * 3),
        ("capture_r2", ctypes.c_float), ("escape_r2", ctypes.c_float),
        ("step_size", ctypes.c_float),
        ("h_near", ctypes.c_float), ("h_disk", ctypes.c_float),
        ("h_cloud", ctypes.c_float), ("h_far", ctypes.c_float),
        ("h6_near", ctypes.c_float), ("h6_disk", ctypes.c_float),
        ("h6_cloud", ctypes.c_float), ("h6_far", ctypes.c_float),
        ("disk_zone_y", ctypes.c_float), ("disk_zone_r2", ctypes.c_float),
        ("cloud_zone_y", ctypes.c_float), ("cloud_zone_r2", ctypes.c_float),
        ("disk_k2", ctypes.c_float), ("disk_rlo2", ctypes.c_float),
        ("disk_rhi2", ctypes.c_float),
        ("cloud_k2", ctypes.c_float), ("cloud_rlo2", ctypes.c_float),
        ("cloud_rhi2", ctypes.c_float),
        ("eh_101", ctypes.c_float), ("eh_1005", ctypes.c_float),
        ("isco", ctypes.c_float), ("disk_out", ctypes.c_float),
        ("edge_start", ctypes.c_float), ("edge_width", ctypes.c_float),
        ("disk_h", ctypes.c_float), ("disk_temp_ref", ctypes.c_float),
        ("disk_lum", ctypes.c_float), ("disk_opacity", ctypes.c_float),
        ("cloud_edge_w", ctypes.c_float), ("taper_w", ctypes.c_float),
        ("cloud_h_half", ctypes.c_float), ("cloud_lum", ctypes.c_float),
        ("cloud_opacity", ctypes.c_float),
        ("enable_disk", ctypes.c_int), ("enable_clouds", ctypes.c_int),
        ("has_spin", ctypes.c_int), ("has_mass_pos", ctypes.c_int),
        ("oct5", ctypes.c_int), ("oct2", ctypes.c_int),
    ]


class CamScalars(ctypes.Structure):
    """Mirror of `struct CamScalars` in csrc/march_common.cuh."""

    _fields_ = [("s", ctypes.c_float * 16)]


class RayGrid(ctypes.Structure):
    """Mirror of `struct RayGrid` in csrc/march_common.cuh: where a
    launch's pixels sit in the full image (shard origin, strip maps)."""

    _fields_ = [("x0", ctypes.c_float), ("y0", ctypes.c_float),
                ("img_w", ctypes.c_int), ("img_h", ctypes.c_int),
                ("sh", ctypes.c_int), ("ystride", ctypes.c_int),
                ("sw", ctypes.c_int), ("xstride", ctypes.c_int)]


def scene_consts(scene: SceneConfig) -> SceneConsts:
    """The scene's kernel constants. Each is the Python-double expression
    the JAX package folds before it meets a float32 array, rounded to
    float32 once (e.g. `-1.5 * eh`, `(eh * 1.01) ** 2`)."""
    eh = scene.event_horizon
    dk2, drlo2, drhi2 = disk_probe_bounds(scene)
    ck2, crlo2, crhi2 = cloud_probe_bounds(scene)
    vals = dict(
        eh=eh, inside_r2=(eh * 0.5) * (eh * 0.5), radial_k=-1.5 * eh,
        spin_k=2.0 * scene.spin_a * eh, spin_a=scene.spin_a,
        capture_r2=(eh * 1.01) ** 2, escape_r2=scene.escape_radius ** 2,
        step_size=scene.step_size_m,
        disk_zone_y=scene.disk_h_m * 5.0,
        disk_zone_r2=(scene.disk_out_m + 5.0) ** 2,
        cloud_zone_y=scene.cloud_h_m * 1.5,
        cloud_zone_r2=scene.cloud_out_m ** 2,
        disk_k2=dk2, disk_rlo2=drlo2, disk_rhi2=drhi2,
        cloud_k2=ck2, cloud_rlo2=crlo2, cloud_rhi2=crhi2,
        eh_101=eh * 1.01, eh_1005=eh * 1.005,
        isco=scene.isco_radius, disk_out=scene.disk_out_m,
        edge_start=scene.disk_out_m * 0.85,
        edge_width=scene.disk_out_m - scene.disk_out_m * 0.85,
        disk_h=scene.disk_h_m, disk_temp_ref=scene.disk_temp_ref,
        disk_lum=scene.disk_luminosity, disk_opacity=scene.disk_opacity,
        cloud_edge_w=scene.disk_out_m * 0.8 - scene.disk_out_m,
        taper_w=(scene.isco_radius + 5.0) - scene.isco_radius,
        cloud_h_half=scene.cloud_h_m * 0.5,
        cloud_lum=scene.cloud_luminosity, cloud_opacity=scene.cloud_opacity,
    )
    c = SceneConsts(**{k: float(np.float32(v)) for k, v in vals.items()})
    # render/march.adaptive_h's step sizes, float32 products, and h / 6 for
    # rk4_step, a float32 quotient (IEEE round-to-nearest, as div.rn.f32)
    for name, m in (("near", 0.1), ("disk", 0.3), ("cloud", 0.5), ("far", 1.0)):
        h = np.float32(scene.step_size_m) * np.float32(m)
        setattr(c, f"h_{name}", float(h))
        setattr(c, f"h6_{name}", float(h / np.float32(6.0)))
    c.spin_axis[:] = [float(np.float32(a)) for a in scene.spin_axis]
    c.mass_pos[:] = [float(np.float32(a)) for a in scene.mass_pos]
    c.enable_disk = int(scene.enable_disk)
    c.enable_clouds = int(scene.enable_clouds)
    c.has_spin = int(scene.spin_a != 0.0)
    c.has_mass_pos = int(tuple(scene.mass_pos) != (0.0, 0.0, 0.0))
    c.oct5 = scene.octaves(5)
    c.oct2 = scene.octaves(2)
    return c


def cam_scalars(scal: np.ndarray) -> CamScalars:
    s = np.asarray(scal, np.float32)
    if s.shape != (16,):
        raise ValueError(f"expected 16 camera scalars, got shape {s.shape}")
    out = CamScalars()
    out.s[:] = [float(v) for v in s]
    return out


def ray_grid(width: int, height: int, origin=None, img_w: Optional[int] = None,
             img_h: Optional[int] = None, strips=None, cstrips=None) -> RayGrid:
    """The RayGrid of a (height, width) launch: the whole image by default;
    a shard passes its global `origin=(x0, y0)` inside an (img_h, img_w)
    frame and optional `strips=(sh, ystride)` / `cstrips=(sw, xstride)`
    (ops/pallas_march._gen_tile_rays)."""
    x0, y0 = (0.0, 0.0) if origin is None else origin
    sh, ystride = strips or (0, 0)
    sw, xstride = cstrips or (0, 0)
    return RayGrid(float(np.float32(x0)), float(np.float32(y0)),
                   width if img_w is None else img_w, height if img_h is None else img_h,
                   sh, ystride, sw, xstride)


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = Path(cuda_home) / "bin" / "nvcc"
    if path.exists():
        return str(path)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")
    return found


def _flags(fmad: bool, timeline: bool):
    return (ARCH_FLAGS + BASE_FLAGS + [f"-fmad={'true' if fmad else 'false'}"]
            + (["-DRRT_TIMELINE"] if timeline else []))


# The fused march's pixel tiles (csrc/march.cu): one warp renders a
# TILE_W x TILE_H patch.
TILE_W, TILE_H = 8, 4


def tile_count(width: int, height: int) -> int:
    """Tiles of a (height, width) march launch: csrc/march.cu::tiles_of."""
    return -(-width // TILE_W) * -(-height // TILE_H)


def tile_map(width: int, height: int):
    """Plain twin of csrc/march.cu::tile_pixel: (x, y, inside), each
    [tiles, 32] — lane l of tile t renders local pixel (x[t, l], y[t, l])
    when inside[t, l]; lanes past the right or bottom edge idle."""
    tiles_x = -(-width // TILE_W)
    t = np.arange(tile_count(width, height))[:, None]
    lane = np.arange(32)[None, :]
    x = (t % tiles_x) * TILE_W + lane % TILE_W
    y = (t // tiles_x) * TILE_H + lane // TILE_W
    return x, y, (x < width) & (y < height)


def straight_line_cost(consts: "SceneConsts", origin, direction, max_steps: int):
    """Plain twin of csrc/march.cu::straight_line_cost on tensors (the same
    operations in the same order): each ray's cost in vacuum steps along
    its straight line — steps near the hole at h_near, in the disk zone's
    slab at h_disk, else h_far, at most max_steps; plus the media probes'
    slabs where it crosses y = 0, weighted by their extra work — int32. An
    order key for the march's tiles, never part of a ray's values."""
    dx, dy, dz = direction
    ox, oy, oz = origin
    if consts.has_mass_pos:
        ox, oy, oz = ox - consts.mass_pos[0], oy - consts.mass_pos[1], oz - consts.mass_pos[2]
    dd = dx * dx + dy * dy + dz * dz
    inv = fdiv(1.0, torch.sqrt(dd))
    ux, uy, uz = dx * inv, dy * inv, dz * inv
    tca = -(ox * ux + oy * uy + oz * uz)
    b2 = torch.clamp((ox * ox + oy * oy + oz * oz) - tca * tca, min=0.0)
    eh = consts.eh
    bc2 = float(np.float32(np.float32(6.75) * np.float32(eh)) * np.float32(eh))
    escape = tca + torch.sqrt(torch.clamp(consts.escape_r2 - b2, min=0.0))
    t_end = torch.clamp(torch.where(b2 < bc2, tca, escape), min=0.0)

    def chord(r2):
        half = torch.sqrt(torch.clamp(r2 - b2, min=0.0))
        inside = b2 < r2
        return torch.where(inside, tca - half, 0.0), torch.where(inside, tca + half, 0.0)

    def clipped(t0, t1):
        return torch.clamp(torch.minimum(t1, t_end) - torch.clamp(t0, min=0.0), min=0.0)

    n0, n1 = chord(324.0)
    z0, z1 = chord(consts.disk_zone_r2)
    zy = consts.disk_zone_y
    slanted = uy.abs() > float(np.float32(1e-6))
    safe_uy = torch.where(slanted, uy, 1.0)
    a, b = fdiv(-zy - oy, safe_uy), fdiv(zy - oy, safe_uy)
    in_slab = oy.abs() < zy
    s0 = torch.where(slanted, torch.minimum(a, b), torch.where(in_slab, -3.0e38, 0.0))
    s1 = torch.where(slanted, torch.maximum(a, b), torch.where(in_slab, 3.0e38, 0.0))
    d0, d1 = torch.maximum(z0, s0), torch.minimum(z1, s1)
    l_near = clipped(n0, n1)
    l_disk = clipped(d0, d1) - clipped(torch.maximum(d0, n0), torch.minimum(d1, n1))
    l_far = torch.clamp(t_end - l_near - l_disk, min=0.0)
    est = fdiv(l_far, consts.h_far) + fdiv(l_disk, consts.h_disk) + fdiv(l_near, consts.h_near)
    est = torch.where(est < max_steps, est, float(max_steps))
    # the media probes' slabs where the line crosses y = 0, in vacuum-step
    # units: a disk-probe step costs ~6 vacuum steps, a cloud-probe step ~21
    tp = fdiv(-oy, safe_uy)
    crossing = slanted & (tp > 0.0) & (tp < t_end)
    px, pz = ox + tp * ux, oz + tp * uz
    rc2 = torch.clamp(px * px + pz * pz, min=float(np.float32(1e-6)))
    h_at = torch.where(rc2 < 324.0, consts.h_near, consts.h_disk)
    per_unit = fdiv(2.0, uy.abs() * h_at)
    for enabled, k2, lo2, hi2, zone, root, weight in (
            (consts.enable_disk, consts.disk_k2, consts.disk_rlo2, consts.disk_rhi2,
             consts.disk_zone_y, lambda q: torch.sqrt(torch.sqrt(q)), 6.0),
            (consts.enable_clouds, consts.cloud_k2, consts.cloud_rlo2, consts.cloud_rhi2,
             consts.cloud_zone_y, lambda q: torch.pow(q, float(np.float32(0.1))), 21.0)):
        if enabled:
            slab = torch.clamp(root(fdiv(k2, rc2)), max=zone)
            est = torch.where(crossing & (rc2 >= lo2) & (rc2 <= hi2),
                              est + weight * per_unit * slab, est)
    est = torch.where(dd > 0.0, est, float(max_steps))
    return torch.clamp(est, max=1.0e9).trunc().to(torch.int32)


def tile_keys_plain(consts: "SceneConsts", origin, direction, max_steps: int) -> torch.Tensor:
    """Plain twin of csrc/march.cu::tile_keys_kernel: per tile the largest
    straight_line_cost of its rays (0 for idle lanes)."""
    height, width = origin[0].shape
    cost = straight_line_cost(consts, origin, direction, max_steps)
    x, y, inside = (torch.as_tensor(a, device=cost.device) for a in tile_map(width, height))
    per_lane = torch.where(inside, cost[y.clamp(max=height - 1), x.clamp(max=width - 1)], 0)
    return per_lane.amax(dim=1)


def order_from_keys(keys: torch.Tensor) -> torch.Tensor:
    """The march's launch order from its tile keys: the tiles costing at
    least 1.5x the launch's cheapest first, then the rest, each class in
    row-major order (a stable sort of the class), int32. On the device,
    with no host sync."""
    expensive = keys >= keys.min() * 3 // 2
    return torch.argsort(expensive.to(torch.int32), descending=True, stable=True).to(torch.int32)


# The replay's kernels (csrc/replay.cu): the plan's round table, march,
# disk and cloud shading, compositing (the passes, once a round), and the
# per-ray replay of the rays the rounds do not take; each launch counts
# under its own name.
REPLAY_PASSES = ("replay_rounds", "replay_march", "replay_shade_disk", "replay_shade_cloud",
                 "replay_composite", "replay_overflow")
# The march pass's segment order (KernelLibrary.replay_segments): a sort of
# the rounds' segments in passes of RADIX_BITS, two launches a pass.
SEGMENT_PASSES = ("replay_segments_hist", "replay_segments_scatter")
# replay.cu's SEG_TILE, RADIX_BITS and MAX_ROUNDS
SEGMENT_TILE = 2048
RADIX_BITS = 8
MAX_ROUNDS = 64
# Waves of resident blocks a replay grid holds at most: round 0's passes and
# the per-ray kernel, then the later rounds' passes. Measured on an H100
# over the default paths' frames (tools/replay_traffic.py): one wave leaves
# the shade passes' uneven steps unbalanced (the headline's replay 3.48 ms),
# one thread an item pays ~1 ms for the empty blocks of a large step list
# (4.30 ms), four waves 3.31 ms. A later round is empty on most frames and
# then costs its launches alone: the headline's 6 empty rounds took 0.070
# ms at one wave and 0.130 at four; a later round with rays holds up to a
# full list, where one wave took 1.85 ms against 1.71 at four (the
# headline forced to half its steps; H100).
REPLAY_WAVES = 4
ROUND_WAVES = 1
# The measurement probes (csrc/probes.cu): tools/roofline.py's op chains and
# tools/sky_primitives.py's block-resident gather.
PROBES = ("chain", "take_along")
CHAIN_OPS = ("fma", "mul", "mul_bf16", "rsqrt", "exp")
KERNELS = (("record",) + REPLAY_PASSES + SEGMENT_PASSES
           + ("sky", "march_sky", "march_camera", "march_planes")
           + PROBES)


class KernelLibrary:
    """One built and loaded copy of the kernels (see the module docstring).

    `launches[name]` counts the launches of each kernel; the wrapper adds
    one right where it launches, and nowhere else."""

    def __init__(self, fmad: bool = False, timeline: bool = False):
        self.fmad = fmad
        self.timeline = timeline
        self.build_seconds = 0.0
        self.build_log = ""
        self.launches = dict.fromkeys(KERNELS, 0)
        self.path = self._build()
        self._lib = ctypes.CDLL(str(self.path))
        self._declare()
        for name, struct in (("scene_consts", SceneConsts), ("ray_grid", RayGrid)):
            size = getattr(self._lib, f"rrt_{name}_size")()
            if size != ctypes.sizeof(struct):
                raise RuntimeError(
                    f"{struct.__name__} layout mismatch: C {size} B, ctypes "
                    f"{ctypes.sizeof(struct)} B")

    def _build(self) -> Path:
        flags = _flags(self.fmad, self.timeline)
        h = hashlib.sha256(" ".join(flags).encode())
        for name in SOURCES + HEADERS:
            h.update(name.encode())
            h.update((CSRC / name).read_bytes())
        out = BUILD_DIR / f"librrt_kernels_{h.hexdigest()[:16]}.so"
        if out.exists():
            return out
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
            tmp = Path(tmp)
            t0 = time.perf_counter()
            # one nvcc per source, all at once; then one link
            procs = []
            for src in SOURCES:
                keep = tmp / Path(src).stem
                keep.mkdir()
                cmd = ([_nvcc()] + flags + ["-c", "-keep", "-keep-dir", str(keep),
                                            "-o", str(keep / "obj.o"), str(CSRC / src)])
                procs.append((src, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                    stderr=subprocess.STDOUT, text=True)))
            logs, failed = [], []
            for src, proc in procs:
                logs.append(f"== {src}\n{proc.communicate()[0]}")
                if proc.returncode != 0:
                    failed.append(src)
            self.build_log = "".join(logs)
            so = tmp / out.name
            if not failed:
                link = subprocess.run([_nvcc()] + ARCH_FLAGS + ["-shared", "-o", str(so)]
                                      + [str(tmp / Path(src).stem / "obj.o") for src in SOURCES],
                                      capture_output=True, text=True)
                self.build_log += link.stdout + link.stderr
                if link.returncode != 0:
                    failed.append("link")
            self.build_seconds = time.perf_counter() - t0
            if failed:
                raise RuntimeError(f"nvcc failed ({', '.join(failed)}):\n{self.build_log}")
            bad = [line for ptx in tmp.glob("*/*.ptx")
                   for line in fp64_instructions(ptx.read_text())]
            if bad:
                raise RuntimeError("kernel build computes in fp64:\n" + "\n".join(bad))
            os.replace(so, out)
        return out

    def _declare(self):
        vp, ci, cf, cl = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
        lib = self._lib
        sc, cam = ctypes.POINTER(SceneConsts), ctypes.POINTER(CamScalars)
        argtypes = {
            "scene_consts_size": [],
            "ray_grid_size": [],
            "record": [sc, cam, ctypes.POINTER(RayGrid)] + [ci] * 6 + [vp] * 7,
            "replay_rounds": [vp, vp, cl, ci, vp, vp, vp],
            "replay_segments_hist": [vp] * 4 + [ci] * 6 + [vp] * 6,
            "replay_segments_scatter": [vp] * 4 + [ci] * 6 + [vp] * 8,
            "replay_march": [sc, ci, cl, ci, ci, ci] + [vp] * 6,
            "replay_march_attrs": [vp],
            "replay_shade": [sc, cf, ci, cl, ci] + [vp] * 5,
            "replay_composite": [ci, cl, ci] + [vp] * 7,
            "replay_overflow": [sc, cf, ci, cl, ci, ci, ci] + [vp] * 7,
            "sky": [cl, ci] + [vp] * 10,
            "march_sky": [sc, cam] + [ci] * 5 + [vp] * 7,
            "march_camera": [sc, cam] + [ci] * 3 + [vp] * 6,
            "march_planes": [sc, cf] + [ci] * 3 + [vp] * 7,
            "march_tile_keys": [sc, cam] + [ci] * 3 + [vp] * 3,
            "march_attrs": [sc, ci, ci, vp],
            "record_attrs": [ci, vp],
            "chain": [ci, ci, ci, vp, vp, vp],
            "take_along": [ci, ci, vp, vp, vp, vp],
        }
        if self.timeline:
            argtypes["set_timeline"] = [vp]
        for name, types in argtypes.items():
            fn = getattr(lib, f"rrt_{name}")
            fn.argtypes = types
            fn.restype = ci

    def reset_launches(self) -> None:
        self.launches = dict.fromkeys(KERNELS, 0)

    def _launched(self, name: str, err: int) -> None:
        """Counts a launch the C launcher made (err 0); raises on a CUDA
        error; a launcher that had no work returns NOT_LAUNCHED and counts
        nothing."""
        if err == NOT_LAUNCHED:
            return
        if err != 0:
            raise RuntimeError(f"CUDA error {err} launching the {name} kernel")
        self.launches[name] += 1

    def record(self, consts, cam, grid, width, height, max_steps, slots, sky_h, sky_w,
               hit, idx, fx, fy, rec, total, stream) -> None:
        """`rec` must hold zeros: the kernel writes records only."""
        shape = (height, width)
        check("record", [(hit, torch.float32, shape),
                         (idx, torch.int32, (3,) + shape),
                         (fx, torch.float32, (3,) + shape),
                         (fy, torch.float32, (3,) + shape),
                         (rec, torch.float32, (slots, 7) + shape),
                         (total, torch.float32, shape)])
        with torch.cuda.device(hit.device):
            err = self._lib.rrt_record(
                ctypes.byref(consts), ctypes.byref(cam), ctypes.byref(grid), width, height,
                max_steps, slots, sky_h, sky_w, hit.data_ptr(), idx.data_ptr(),
                fx.data_ptr(), fy.data_ptr(), rec.data_ptr(), total.data_ptr(), stream)
        self._launched("record", err)

    def replay_rounds(self, csum, listed, capacity, table, counts, stream) -> None:
        """The plan's round table (ops/pallas_compact.replay_plan): from
        `csum` [L + 1] int64 (0, then the listed rays' step ends along the
        list) and `listed` (int64 scalar, m) on the card, each round's (first
        listed ray, rays, base, steps) to `table` [R, 4] and (m, m_r, S,
        S_r) to `counts` [4]; one block, no host sync."""
        rounds = table.shape[0]
        check("replay_rounds", [(csum, torch.int64, tuple(csum.shape)),
                                (listed, torch.int64, ()), (table, torch.int64, (rounds, 4)),
                                (counts, torch.int64, (4,))])
        if rounds < 1 or capacity < 1:
            raise ValueError(f"replay_rounds: {rounds} rounds of a {capacity}-entry list")
        with torch.cuda.device(csum.device):
            err = self._lib.rrt_replay_rounds(csum.data_ptr(), listed.data_ptr(), capacity, rounds,
                                              table.data_ptr(), counts.data_ptr(), stream)
        self._launched("replay_rounds", err)

    def replay_segments(self, rec, order, offsets, table, len_bits, stream):
        """The march pass's segment order (ops/pallas_compact.with_segments):
        from the records `rec` [slots, 7, H, W], the plan's `order` (int32
        [L]), `offsets` (int64 [L]) and round table `table` (int64 [R, 4])
        on the card, the rounds' non-empty (listed ray, slot) segments
        sorted by (round, longest first), ties in (ray, slot) order, as
        int32 [L * slots, 2] (list start less the round's base, pixel *
        slots + slot), and int64 [R] segments a round. Lengths take
        `len_bits` bits of the key. No host sync: each pass reads its
        count from the last one's prefix sum; entries past the count stay
        unwritten."""
        slots, _, h, w = rec.shape
        rays, rounds = order.numel(), table.shape[0]
        check("replay_segments", [(rec, torch.float32, (slots, 7, h, w)),
                                  (order, torch.int32, (rays,)), (offsets, torch.int64, (rays,)),
                                  (table, torch.int64, (rounds, 4))])
        if not 1 <= rounds <= MAX_ROUNDS:
            raise ValueError(f"replay_segments: {rounds} rounds (1 to {MAX_ROUNDS})")
        items = rays * slots
        if items >= 1 << 31 or not 1 <= len_bits <= 24:
            raise ValueError(f"replay_segments: {items} items, {len_bits} length bits")
        dev = rec.device
        tiles = max(-(-items // SEGMENT_TILE), 1)
        passes = max(-(-(len_bits + (rounds - 1).bit_length()) // RADIX_BITS), 1)
        keys = [torch.empty(items, dtype=torch.int32, device=dev) for _ in range(2)]
        vals = [torch.empty((items, 2), dtype=torch.int32, device=dev) for _ in range(2)]
        hist = torch.empty((1 << RADIX_BITS) * tiles, dtype=torch.int32, device=dev)
        counts = torch.zeros(rounds, dtype=torch.int64, device=dev)
        plan_args = (rec.data_ptr(), order.data_ptr(), offsets.data_ptr(), table.data_ptr(),
                     rounds, h * w, slots, len_bits)
        scans, count = [], None
        with torch.cuda.device(dev):
            for p in range(passes):
                src, dst = (p + 1) % 2, p % 2
                k_in, v_in = (keys[src].data_ptr(), vals[src].data_ptr()) if p else (None, None)
                err = self._lib.rrt_replay_segments_hist(
                    *plan_args, p, tiles, k_in, v_in, count, hist.data_ptr(), counts.data_ptr(),
                    stream)
                self._launched("replay_segments_hist", err)
                # the next pass reads its count from this scan: keep each alive
                scans.append(torch.cumsum(hist, 0, dtype=torch.int32))
                err = self._lib.rrt_replay_segments_scatter(
                    *plan_args, p, tiles, k_in, v_in, count, hist.data_ptr(),
                    scans[-1].data_ptr(), keys[dst].data_ptr() if p + 1 < passes else None,
                    vals[dst].data_ptr(), stream)
                self._launched("replay_segments_scatter", err)
                count = scans[-1].data_ptr() + (scans[-1].numel() - 1) * scans[-1].element_size()
        return vals[(passes - 1) % 2], counts

    def replay_march(self, consts, rec, plan, r, pos, vel, stream) -> None:
        """Pass 1 of round `r` of `plan` (ops/pallas_compact.ReplayPlan,
        with its segment order): each of the round's segments, longest
        first, -> its steps' PRE-step rel and POST-step v, `pos` [C, 4]
        (rel, v.x) and `vel` [C, 2] (v.y, v.z), from its list start on."""
        slots, _, h, w = rec.shape
        rays, cap, rounds = plan.order.numel(), pos.shape[0], plan.rounds.shape[0]
        if plan.segments is None:
            raise ValueError("replay_march: the plan has no segment order (with_segments)")
        if not 0 <= r < rounds:
            raise ValueError(f"round {r} of a {rounds}-round plan")
        check("replay_march", [(rec, torch.float32, (slots, 7, h, w)),
                               (plan.segments, torch.int32, (rays * slots, 2)),
                               (plan.segment_counts, torch.int64, (rounds,)),
                               (pos, torch.float32, (cap, 4)), (vel, torch.float32, (cap, 2))])
        with torch.cuda.device(rec.device):
            err = self._lib.rrt_replay_march(
                ctypes.byref(consts), h * w, min(rays, cap) * slots, slots, _waves(r), r,
                plan.segment_counts.data_ptr(), rec.data_ptr(), plan.segments.data_ptr(),
                pos.data_ptr(), vel.data_ptr(), stream)
        self._launched("replay_march", err)

    def replay_shade(self, consts, time, medium, plan, r, pos, vel, emit, stream) -> None:
        """Pass 2 of round `r`, one thread per entry of the step list (those
        past the round's steps return at once): medium "disk" writes each
        step's (r, g, b, transmittance) to `emit` [C, 4] (the opacity in
        place of the transmittance on cloud-probe steps); "cloud" then adds
        its terms to those steps and writes their transmittance."""
        cap = pos.shape[0]
        check(f"replay_shade_{medium}", [(plan.rounds, torch.int64, (plan.rounds.shape[0], 4)),
                                         (pos, torch.float32, (cap, 4)),
                                         (vel, torch.float32, (cap, 2)),
                                         (emit, torch.float32, (cap, 4))])
        with torch.cuda.device(pos.device):
            err = self._lib.rrt_replay_shade(
                ctypes.byref(consts), time, ("disk", "cloud").index(medium), cap, _waves(r),
                _row(plan, r), pos.data_ptr(), vel.data_ptr(), emit.data_ptr(), stream)
        self._launched(f"replay_shade_{medium}", err)

    def replay_composite(self, plan, r, emit, intensity, trans, stream) -> None:
        """Pass 3 of round `r`: each of the round's rays composites its
        steps in order and writes I and T to its pixel of `intensity` [3, H,
        W] and `trans` [H, W]."""
        h, w = trans.shape
        cap = emit.shape[0]
        check("replay_composite", _plan_specs(plan)
              + [(emit, torch.float32, (cap, 4)),
                 (intensity, torch.float32, (3, h, w)), (trans, torch.float32, (h, w))])
        with torch.cuda.device(trans.device):
            err = self._lib.rrt_replay_composite(
                h * w, min(plan.order.numel(), cap), _waves(r), _row(plan, r),
                plan.order.data_ptr(), plan.offsets.data_ptr(), emit.data_ptr(),
                intensity.data_ptr(), trans.data_ptr(), stream)
        self._launched("replay_composite", err)

    def replay_overflow(self, consts, time, rec, plan, intensity, trans, stream) -> None:
        """The listed rays the rounds of `plan` do not take (before round 0,
        longer than the list, and past the last round), one thread per ray:
        march, shade and composite inline in the passes' order; writes their
        I and T. Launched every frame; it exits at once where the rounds
        take every ray."""
        slots, _, h, w = rec.shape
        check("replay_overflow", [(rec, torch.float32, (slots, 7, h, w))] + _plan_specs(plan)
              + [(intensity, torch.float32, (3, h, w)), (trans, torch.float32, (h, w))])
        with torch.cuda.device(rec.device):
            err = self._lib.rrt_replay_overflow(
                ctypes.byref(consts), time, h * w, plan.order.numel(), slots, REPLAY_WAVES,
                plan.rounds.shape[0], plan.rounds.data_ptr(), plan.counts.data_ptr(),
                rec.data_ptr(), plan.order.data_ptr(), intensity.data_ptr(), trans.data_ptr(),
                stream)
        self._launched("replay_overflow", err)

    def sky(self, use_q4, idx, fx, fy, masked, qr, qg, qb, q4, bg, stream) -> None:
        """Each pixel's background from its quads (csrc/sky.cu); `masked`
        (bool [H, W]) or None: masked pixels get 0."""
        shape = tuple(bg.shape[1:])
        n = bg[0].numel()
        hq_w = tuple(qr.shape)
        planes = [(idx, torch.int32, (3,) + shape),
                  (fx, torch.float32, (3,) + shape),
                  (fy, torch.float32, (3,) + shape),
                  (qr, torch.int32, hq_w), (qg, torch.int32, hq_w),
                  (qb, torch.int32, hq_w),
                  (bg, torch.float32, (3,) + shape)]
        if masked is not None:
            planes.append((masked, torch.bool, shape))
        if use_q4:
            planes.append((q4, torch.int32, (hq_w[0] * hq_w[1], 4)))
        check("sky", planes)
        with torch.cuda.device(bg.device):
            err = self._lib.rrt_sky(
                n, int(use_q4), idx.data_ptr(), fx.data_ptr(), fy.data_ptr(),
                None if masked is None else masked.data_ptr(), qr.data_ptr(), qg.data_ptr(),
                qb.data_ptr(), q4.data_ptr() if use_q4 else None, bg.data_ptr(), stream)
        self._launched("sky", err)

    def tile_keys(self, consts, cam, rays, width, height, max_steps, stream) -> torch.Tensor:
        """csrc/march.cu::tile_keys_kernel: each tile's straight-line cost
        estimate (int32), for rays from the camera (`rays` None) or from
        the [6, H, W] planes `rays`, on the current device."""
        device = rays.device if rays is not None else torch.device(
            "cuda", torch.cuda.current_device())
        keys = torch.empty(tile_count(width, height), dtype=torch.int32, device=device)
        with torch.cuda.device(device):
            err = self._lib.rrt_march_tile_keys(
                ctypes.byref(consts), None if cam is None else ctypes.byref(cam), width, height,
                max_steps, None if rays is None else rays.data_ptr(), keys.data_ptr(), stream)
        if err != 0:
            raise RuntimeError(f"CUDA error {err} launching the march tile-key kernel")
        return keys

    def march_order(self, consts, cam, rays, width, height, max_steps, stream) -> torch.Tensor:
        """The fused march's launch order (order_from_keys of tile_keys): a
        key kernel and a sort on the current device, no host sync."""
        return order_from_keys(self.tile_keys(consts, cam, rays, width, height, max_steps,
                                              stream))

    def march_sky(self, consts, cam, max_steps, sky_h, sky_w, intensity, trans,
                  idx, fx, fy, stream) -> None:
        shape = tuple(trans.shape)
        check("march_sky", [(intensity, torch.float32, (3,) + shape),
                            (trans, torch.float32, shape),
                            (idx, torch.int32, (3,) + shape),
                            (fx, torch.float32, (3,) + shape),
                            (fy, torch.float32, (3,) + shape)])
        height, width = shape
        with torch.cuda.device(trans.device):
            order = self.march_order(consts, cam, None, width, height, max_steps, stream)
            err = self._lib.rrt_march_sky(
                ctypes.byref(consts), ctypes.byref(cam), width, height, max_steps,
                sky_h, sky_w, order.data_ptr(), intensity.data_ptr(), trans.data_ptr(),
                idx.data_ptr(), fx.data_ptr(), fy.data_ptr(), stream)
        self._launched("march_sky", err)

    def march_camera(self, consts, cam, max_steps, intensity, trans, hit, vel,
                     stream) -> None:
        shape = tuple(trans.shape)
        check("march_camera", _state_specs(shape, intensity, trans, hit, vel))
        height, width = shape
        with torch.cuda.device(trans.device):
            order = self.march_order(consts, cam, None, width, height, max_steps, stream)
            err = self._lib.rrt_march_camera(
                ctypes.byref(consts), ctypes.byref(cam), width, height, max_steps,
                order.data_ptr(), intensity.data_ptr(), trans.data_ptr(), hit.data_ptr(),
                vel.data_ptr(), stream)
        self._launched("march_camera", err)

    def march_planes(self, consts, time, max_steps, rays, intensity, trans, hit, vel,
                     stream) -> None:
        shape = tuple(trans.shape)
        check("march_planes", [(rays, torch.float32, (6,) + shape)]
              + _state_specs(shape, intensity, trans, hit, vel))
        height, width = shape
        with torch.cuda.device(trans.device):
            order = self.march_order(consts, None, rays, width, height, max_steps, stream)
            err = self._lib.rrt_march_planes(
                ctypes.byref(consts), time, width, height, max_steps, rays.data_ptr(),
                order.data_ptr(), intensity.data_ptr(), trans.data_ptr(), hit.data_ptr(),
                vel.data_ptr(), stream)
        self._launched("march_planes", err)

    def chain(self, op: str, iters: int, x, out, stream) -> None:
        """csrc/probes.cu::chain_kernel (or chain_bf16_kernel for "mul_bf16"):
        element e of `out` [tiles * 8, 128] float32 runs the 16 op chains
        from x[e % 1024]; `x` is one [8, 128] tile, bfloat16 for "mul_bf16",
        else float32."""
        dtype = torch.bfloat16 if op == "mul_bf16" else torch.float32
        if out.dim() != 2 or out.shape[1] != 128 or out.shape[0] % 8:
            raise ValueError(f"chain: out must be [tiles * 8, 128], got {tuple(out.shape)}")
        check("chain", [(x, dtype, (8, 128)), (out, torch.float32, tuple(out.shape))])
        if iters < 0:
            raise ValueError(f"chain: iters must be >= 0, got {iters}")
        with torch.cuda.device(out.device):
            err = self._lib.rrt_chain(CHAIN_OPS.index(op), iters, out.numel(), x.data_ptr(),
                                      out.data_ptr(), stream)
        self._launched("chain", err)

    def take_along(self, tab, idx, out, stream) -> None:
        """csrc/probes.cu::take_along_kernel: out[8i + r, c] =
        tab[S i + idx[8i + r, c], c] for tab [t * S, 128] float32 and idx,
        out [t * 8, 128] (int32, float32); S <= 64 (its shared tile)."""
        rows = idx.shape[0]
        if idx.dim() != 2 or idx.shape[1] != 128 or rows % 8 or tab.dim() != 2 \
                or tab.shape[0] % max(rows // 8, 1):
            raise ValueError(f"take_along: bad shapes {tuple(tab.shape)}, {tuple(idx.shape)}")
        t = rows // 8
        s = tab.shape[0] // max(t, 1)
        if not 1 <= s <= 64:
            raise ValueError(f"take_along: table rows per tile must be 1..64, got {s}")
        check("take_along", [(tab, torch.float32, (t * s, 128)), (idx, torch.int32, (rows, 128)),
                             (out, torch.float32, (rows, 128))])
        with torch.cuda.device(out.device):
            err = self._lib.rrt_take_along(t, s, tab.data_ptr(), idx.data_ptr(),
                                           out.data_ptr(), stream)
        self._launched("take_along", err)

    def attrs(self, name: str, threads: int, device) -> Dict[str, int]:
        """Registers and local (spill) bytes a thread, and resident blocks
        an SM at `threads` a block, of the record kernel or a fused march
        kernel ("march_sky", "march_camera", "march_planes" in their
        instance for SceneConfig()'s flags; "march_tile_keys") on `device`
        (the CUDA occupancy API)."""
        out = (ctypes.c_int * 3)()
        with torch.cuda.device(device):
            if name == "record":
                err = self._lib.rrt_record_attrs(threads, out)
            else:
                which = ("march_sky", "march_camera", "march_planes", "march_tile_keys").index(name)
                consts = scene_consts(SceneConfig())
                err = self._lib.rrt_march_attrs(ctypes.byref(consts), which, threads, out)
        if err != 0:
            raise RuntimeError(f"CUDA error {err} querying the {name} kernel")
        return dict(regs=out[0], local_bytes=out[1], blocks_per_sm=out[2])

    def replay_march_attrs(self, device) -> Dict[str, int]:
        """The replay march pass's registers and local (spill) bytes a
        thread, resident blocks and warps an SM, threads a block and static
        shared bytes a block on `device` (the CUDA occupancy API)."""
        out = (ctypes.c_int * 5)()
        with torch.cuda.device(device):
            err = self._lib.rrt_replay_march_attrs(out)
        if err != 0:
            raise RuntimeError(f"CUDA error {err} querying the replay_march kernel")
        return dict(regs=out[0], local_bytes=out[1], blocks_per_sm=out[2], threads=out[3],
                    shared_bytes=out[4], warps_per_sm=out[2] * out[3] // 32)

    def set_timeline(self, buf: torch.Tensor) -> None:
        """Timeline build only: the fused march kernels write each warp's
        (SM, start ns, end ns) to `buf` (int64 [slots, 3]) at its launch
        slot."""
        with torch.cuda.device(buf.device):
            err = self._lib.rrt_set_timeline(buf.data_ptr())
        if err != 0:
            raise RuntimeError(f"CUDA error {err} setting the march timeline buffer")


def _plan_specs(plan):
    """Check specs of a replay plan (ops/pallas_compact.ReplayPlan): order
    int32 and offsets int64 of one length, counts int64 [4], the round
    table int64 [R, 4]."""
    rays = plan.order.numel()
    return [(plan.order, torch.int32, (rays,)), (plan.offsets, torch.int64, (rays,)),
            (plan.counts, torch.int64, (4,)), (plan.rounds, torch.int64, (plan.rounds.shape[0], 4))]


def _row(plan, r: int) -> int:
    """Device address of round `r`'s row of the plan's table."""
    if not 0 <= r < plan.rounds.shape[0]:
        raise ValueError(f"round {r} of a {plan.rounds.shape[0]}-round plan")
    return plan.rounds.data_ptr() + r * 4 * plan.rounds.element_size()


def _waves(r: int) -> int:
    """Waves of blocks a replay pass's grid holds in round `r`."""
    return REPLAY_WAVES if r == 0 else ROUND_WAVES


def _state_specs(shape, intensity, trans, hit, vel):
    """Check specs of the march state planes: I and v [3, H, W], T and hit
    [H, W], all float32."""
    return [(intensity, torch.float32, (3,) + shape), (trans, torch.float32, shape),
            (hit, torch.float32, shape), (vel, torch.float32, (3,) + shape)]


_LIBRARIES: Dict[tuple, KernelLibrary] = {}


def kernels(fmad: bool = False, timeline: bool = False) -> KernelLibrary:
    """The kernel library built with the given contraction flag (built and
    loaded once per process). `timeline=True` is the measurement build
    whose fused march kernels record each warp's SM and start and end
    times (KernelLibrary.set_timeline); the default build has none of it."""
    key = (fmad, timeline)
    if key not in _LIBRARIES:
        _LIBRARIES[key] = KernelLibrary(fmad, timeline)
    return _LIBRARIES[key]


def resolve(lib: Optional[KernelLibrary]) -> KernelLibrary:
    return kernels() if lib is None else lib


def current_stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def check(name: str, specs: Sequence) -> None:
    """Raise unless every (tensor, dtype, shape) spec is a contiguous CUDA
    tensor of that dtype and shape, all on one device."""
    dev = specs[0][0].device
    for t, dtype, shape in specs:
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"{name}: tensors must share one CUDA device, got {t.device}")
        if t.dtype != dtype:
            raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")
