"""Build, load and call the hand-written CUDA kernels (csrc/*.cu).

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
from relativisticraytracer_tpu_torch.media.densities import (
    cloud_probe_bounds,
    disk_probe_bounds,
)

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
SOURCES = ("record.cu", "replay.cu", "sky.cu", "march.cu")
HEADERS = ("march_common.cuh",)
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


def _flags(fmad: bool):
    return ARCH_FLAGS + BASE_FLAGS + [f"-fmad={'true' if fmad else 'false'}"]


KERNELS = ("record", "replay", "sky", "march_sky", "march_camera", "march_planes")


class KernelLibrary:
    """One built and loaded copy of the kernels (see the module docstring).

    `launches[name]` counts the launches of each kernel; the wrapper adds
    one right where it launches, and nowhere else."""

    def __init__(self, fmad: bool = False):
        self.fmad = fmad
        self.build_seconds = 0.0
        self.build_log = ""
        self.launches = dict.fromkeys(KERNELS, 0)
        path = self._build()
        self._lib = ctypes.CDLL(str(path))
        self._declare()
        for name, struct in (("scene_consts", SceneConsts), ("ray_grid", RayGrid)):
            size = getattr(self._lib, f"rrt_{name}_size")()
            if size != ctypes.sizeof(struct):
                raise RuntimeError(
                    f"{struct.__name__} layout mismatch: C {size} B, ctypes "
                    f"{ctypes.sizeof(struct)} B")

    def _build(self) -> Path:
        flags = _flags(self.fmad)
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
        vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib = self._lib
        sc, cam = ctypes.POINTER(SceneConsts), ctypes.POINTER(CamScalars)
        argtypes = {
            "scene_consts_size": [],
            "ray_grid_size": [],
            "record": [sc, cam, ctypes.POINTER(RayGrid)] + [ci] * 6 + [vp] * 7,
            "replay": [sc, cf, ci, ci, ci] + [vp] * 5,
            "sky": [ci, ci] + [vp] * 10,
            "march_sky": [sc, cam] + [ci] * 5 + [vp] * 6,
            "march_camera": [sc, cam] + [ci] * 3 + [vp] * 5,
            "march_planes": [sc, cf] + [ci] * 3 + [vp] * 6,
        }
        for name, types in argtypes.items():
            fn = getattr(lib, f"rrt_{name}")
            fn.argtypes = types
            fn.restype = ci

    def reset_launches(self) -> None:
        self.launches = dict.fromkeys(KERNELS, 0)

    def _launched(self, name: str, err: int) -> None:
        if err != 0:
            raise RuntimeError(f"CUDA error {err} launching the {name} kernel")
        self.launches[name] += 1

    def record(self, consts, cam, grid, width, height, max_steps, slots, sky_h, sky_w,
               hit, idx, fx, fy, rec, total, stream) -> None:
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

    def replay(self, consts, time, n, m, slots, rec, order, intensity, trans,
               stream) -> None:
        h, w = trans.shape
        if h * w != n:
            raise ValueError(f"replay: {n} pixels vs planes {tuple(trans.shape)}")
        check("replay", [(rec, torch.float32, (slots, 7, h, w)),
                         (order, torch.int32, (m,)),
                         (intensity, torch.float32, (3, h, w)),
                         (trans, torch.float32, (h, w))])
        with torch.cuda.device(rec.device):
            err = self._lib.rrt_replay(
                ctypes.byref(consts), time, n, m, slots, rec.data_ptr(),
                order.data_ptr(), intensity.data_ptr(), trans.data_ptr(), stream)
        self._launched("replay", err)

    def sky(self, use_q4, idx, fx, fy, masked, qr, qg, qb, q4, bg, stream) -> None:
        shape = tuple(masked.shape)
        n = masked.numel()
        hq_w = tuple(qr.shape)
        planes = [(idx, torch.int32, (3,) + shape),
                  (fx, torch.float32, (3,) + shape),
                  (fy, torch.float32, (3,) + shape),
                  (masked, torch.bool, shape),
                  (qr, torch.int32, hq_w), (qg, torch.int32, hq_w),
                  (qb, torch.int32, hq_w),
                  (bg, torch.float32, (3,) + shape)]
        if use_q4:
            planes.append((q4, torch.int32, (hq_w[0] * hq_w[1], 4)))
        check("sky", planes)
        with torch.cuda.device(bg.device):
            err = self._lib.rrt_sky(
                n, int(use_q4), idx.data_ptr(), fx.data_ptr(), fy.data_ptr(),
                masked.data_ptr(), qr.data_ptr(), qg.data_ptr(), qb.data_ptr(),
                q4.data_ptr() if use_q4 else None, bg.data_ptr(), stream)
        self._launched("sky", err)

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
            err = self._lib.rrt_march_sky(
                ctypes.byref(consts), ctypes.byref(cam), width, height, max_steps,
                sky_h, sky_w, intensity.data_ptr(), trans.data_ptr(), idx.data_ptr(),
                fx.data_ptr(), fy.data_ptr(), stream)
        self._launched("march_sky", err)

    def march_camera(self, consts, cam, max_steps, intensity, trans, hit, vel,
                     stream) -> None:
        shape = tuple(trans.shape)
        check("march_camera", _state_specs(shape, intensity, trans, hit, vel))
        height, width = shape
        with torch.cuda.device(trans.device):
            err = self._lib.rrt_march_camera(
                ctypes.byref(consts), ctypes.byref(cam), width, height, max_steps,
                intensity.data_ptr(), trans.data_ptr(), hit.data_ptr(), vel.data_ptr(),
                stream)
        self._launched("march_camera", err)

    def march_planes(self, consts, time, max_steps, rays, intensity, trans, hit, vel,
                     stream) -> None:
        shape = tuple(trans.shape)
        check("march_planes", [(rays, torch.float32, (6,) + shape)]
              + _state_specs(shape, intensity, trans, hit, vel))
        height, width = shape
        with torch.cuda.device(trans.device):
            err = self._lib.rrt_march_planes(
                ctypes.byref(consts), time, width, height, max_steps, rays.data_ptr(),
                intensity.data_ptr(), trans.data_ptr(), hit.data_ptr(), vel.data_ptr(),
                stream)
        self._launched("march_planes", err)


def _state_specs(shape, intensity, trans, hit, vel):
    """Check specs of the march state planes: I and v [3, H, W], T and hit
    [H, W], all float32."""
    return [(intensity, torch.float32, (3,) + shape), (trans, torch.float32, shape),
            (hit, torch.float32, shape), (vel, torch.float32, (3,) + shape)]


_LIBRARIES: Dict[bool, KernelLibrary] = {}


def kernels(fmad: bool = False) -> KernelLibrary:
    """The kernel library built with the given contraction flag (built and
    loaded once per process)."""
    if fmad not in _LIBRARIES:
        _LIBRARIES[fmad] = KernelLibrary(fmad)
    return _LIBRARIES[fmad]


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
