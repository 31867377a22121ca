"""Spatial-shard rendering over a grid of devices (port of
relativisticraytracer_tpu.parallel.sharding).

The frame is cut into an (ny, nx) grid of rectangles and each grid cell's
device renders its own. Every ray is independent, so the program has no
collectives: each shard's uint8 tile is copied to the grid's first device
at the end (the analog of the reference's glReadPixels, main.cpp:89). A
grid cell names a `torch.device`, and one device may fill several cells:
its shards then run one after another, which is how one card runs an
8-shard frame.

Two branches, as in the JAX package:

  * compact (the kernel loop, `media_pass="compact"`, a sky and a
    medium): each shard runs the single-device record/replay/sky program
    on its rectangle, with its global pixel origin and, when interleaved,
    strip maps in the record kernel's ray generation
    (ops/pallas_compact._compact_tile_rgba);
  * otherwise: the full frame's rays are generated once, and each shard
    marches its slice of them, with the fused plane march
    (ops/pallas_march.march_pallas) on the kernel loop or with the plain
    march (render/march.render_hdr) for `loop` "while" or "scan", then
    samples the sky and runs the epilogue on its tile.

Either way a shard's tile is bitwise the matching crop of the
single-device frame. With strip interleaving the returned frame is in
device-block layout: `reassemble_strips` restores image order.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from relativisticraytracer_tpu_torch.config import (
    CameraEffects,
    RenderSettings,
    SceneConfig,
    kernel_loop,
)
from relativisticraytracer_tpu_torch.core.vecmath import Vec3, normalize
from relativisticraytracer_tpu_torch.ops.pallas_compact import _compact_tile_rgba
from relativisticraytracer_tpu_torch.ops.pallas_march import _time_tensor, march_pallas
from relativisticraytracer_tpu_torch.ops.pallas_sky import sky_background_windowed
from relativisticraytracer_tpu_torch.render.camera import CameraState, generate_rays
from relativisticraytracer_tpu_torch.render.march import render_hdr
from relativisticraytracer_tpu_torch.render.pipeline import background
from relativisticraytracer_tpu_torch.render.postfx import (
    apply_effects_and_tonemap,
    downsample_box,
    pack_rgba8,
)
from relativisticraytracer_tpu_torch.render.skybox import Skybox, sky_coords


@dataclasses.dataclass(frozen=True)
class Mesh:
    """An (ny, nx) grid of devices: `devices[i, j]` renders shard row i,
    column j. The same device may fill several cells."""

    devices: np.ndarray  # object array of torch.device, shape (ny, nx)

    @property
    def shape(self) -> Tuple[int, int]:
        return self.devices.shape


def _factor2(n: int) -> Tuple[int, int]:
    """Most-square (rows, cols) factorization of n."""
    best = (n, 1)
    for a in range(1, int(math.isqrt(n)) + 1):
        if n % a == 0:
            best = (n // a, a)
    return best


def strip_height(extent: int, n: int, ss: int = 1, target: int = 16) -> int:
    """Strip size for interleaved shard assignment along one image axis:
    shard i of n takes strips i, i+n, i+2n, ... of `strip` rows each, so
    the photon-ring rows at the image centre spread over all shards (the
    frame time is the slowest shard's).

    Picks the divisor of extent//n closest to `target` (ties to the
    smaller) that is a multiple of `ss` (supersampling boxes must not
    straddle strips); the whole band when no proper divisor fits."""
    per = extent // n
    if extent % n:
        raise ValueError(f"extent {extent} not divisible by {n} shards")
    cands = [d for d in range(1, per) if per % d == 0 and d % ss == 0]
    if not cands:
        if per % ss:
            raise ValueError(f"no strip size divides {per} with ss={ss}")
        return per
    return min(cands, key=lambda d: (abs(d - target), d))


def reassemble_strips(frame: np.ndarray, ny: int, nx: int, sh: int, sw: int) -> np.ndarray:
    """Undo the strip-interleaved shard layout on the host.

    `frame` is the (H, W, C) output of the interleaved sharded renderer:
    shard (i, j)'s tile sits at block (i, j), and its local row r holds
    global row (r // sh * ny + i) * sh + r % sh (columns likewise with
    sw/nx; sw=0 or nx=1 means contiguous columns). A pure permutation."""
    frame = np.asarray(frame)
    h, w = frame.shape[:2]
    rest = frame.shape[2:]
    out = frame
    if ny > 1 and sh:
        kr = h // ny // sh
        out = out.reshape(ny, kr, sh, w, *rest)
        out = out.transpose(1, 0, 2, *range(3, out.ndim))
        out = out.reshape(h, w, *rest)
    if nx > 1 and sw:
        kc = w // nx // sw
        out = out.reshape(h, nx, kc, sw, *rest)
        out = out.transpose(0, 2, 1, *range(3, out.ndim))
        out = out.reshape(h, w, *rest)
    return out


def shard_settings(settings: RenderSettings, ny: int, nx: int,
                   interleave: bool) -> RenderSettings:
    """Per-shard settings for an (ny, nx) grid: the JAX package's static
    replay capacity shrinks with the shard (2/N of the frame's when
    interleaved, 2/nx for contiguous rectangles). The port sizes each
    shard's replay step list from its own pixels, so `media_capacity`
    selects nothing here; it is kept so that both packages hand their
    shards the same settings."""
    n_shards = ny * nx if interleave else nx
    shard_cap = max(2 * settings.media_capacity // max(n_shards, 1), 8 * 128)
    return dataclasses.replace(settings,
                               media_capacity=min(settings.media_capacity, shard_cap))


def _compact_ok(scene: SceneConfig, settings: RenderSettings, sky) -> bool:
    return (kernel_loop(settings) and settings.media_pass == "compact" and sky is not None
            and (scene.enable_disk or scene.enable_clouds))


def resolve_interleave(scene: SceneConfig, settings: RenderSettings, interleave) -> bool:
    """The `interleave` knob: "auto" strip-interleaves whenever the compact
    branch applies (the kernel loop, compact media pass and a medium; the
    sky is checked at call time), True/False force it."""
    if interleave == "auto":
        return (kernel_loop(settings) and settings.media_pass == "compact"
                and (scene.enable_disk or scene.enable_clouds))
    return bool(interleave)


def make_mesh(devices: Optional[Sequence] = None,
              shape: Optional[Tuple[int, int]] = None) -> Mesh:
    """An (ny, nx) grid over `devices` (default: every CUDA device), in
    row-major order; `shape` defaults to the most square factorization.
    Repeat a device to run several shards on it, e.g. `["cuda:0"] * 8`."""
    if devices is None:
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
        if not devices:
            raise RuntimeError("make_mesh: no CUDA device; pass `devices` "
                               "(e.g. ['cpu'] * 4)")
    devices = [torch.device(d) for d in devices]
    if shape is None:
        shape = _factor2(len(devices))
    ny, nx = shape
    if ny * nx != len(devices):
        raise ValueError(f"mesh shape {shape} != {len(devices)} devices")
    grid = np.empty((ny, nx), dtype=object)
    for k, d in enumerate(devices):
        grid[k // nx, k % nx] = d
    return Mesh(grid)


def _interleave_strips_ss(H: int, W: int, ny: int, nx: int, ss: int):
    """(sh, sw) strip sizes in supersampled pixels for an interleaved
    (ny, nx) grid over an (H, W) supersampled frame. Columns interleave
    only for nx > 2: a centred scene splits evenly over two contiguous
    halves."""
    sh = strip_height(H, ny, ss=ss) if ny > 1 else 0
    sw = strip_height(W, nx, ss=ss, target=128) if nx > 2 else 0
    return sh, sw


def interleave_params(settings: RenderSettings, mesh: Mesh):
    """(ny, nx, sh_out, sw_out) for reassemble_strips, in output pixels
    (after the supersample resolve)."""
    ny, nx = mesh.shape
    ss = settings.supersample
    H, W = settings.height * ss, settings.width * ss
    sh, sw = _interleave_strips_ss(H, W, ny, nx, ss)
    return ny, nx, sh // ss, sw // ss


def tile_background(sky: Skybox, vel: Vec3, effects: CameraEffects) -> Vec3:
    """The sky behind a tile's rays, from their final velocities: the sky
    coordinates of each direction, fetched by the sky kernel (its plain
    version on the CPU) as in the inline frame. No mask: captured rays
    have transmittance 0, which erases their background. Bitwise
    render.skybox.sample_sky_fast."""
    coords = sky_coords(normalize(vel), effects.ca_offset(), *sky.shape)
    idx, fx, fy = (torch.stack(planes) for planes in zip(*coords))
    return sky_background_windowed(sky, idx, fx, fy, effects)


# (grid cell (i, j), its device, a call that renders its uint8 tile there)
ShardProgram = Tuple[Tuple[int, int], torch.device, Callable[[], torch.Tensor]]


def _shard_programs(scene: SceneConfig, settings: RenderSettings, mesh: Mesh,
                    camera: CameraState, effects: CameraEffects, time,
                    sky: Optional[Skybox], interleave=False) -> List[ShardProgram]:
    """One program per grid cell; render_frame_sharded runs them in grid
    order. Each shard's tile is [H/ny, W/nx, 4] uint8 on its device."""
    ny, nx = mesh.shape
    if settings.height % ny or settings.width % nx:
        raise ValueError(f"image {settings.height}x{settings.width} not divisible "
                         f"by mesh {ny}x{nx}")
    ss = settings.supersample
    W, H = settings.width * ss, settings.height * ss
    tw, th = W // nx, H // ny
    interleave = resolve_interleave(scene, settings, interleave)
    compact = _compact_ok(scene, settings, sky)
    if interleave and not compact:
        raise ValueError("interleave=True requires the compact fast path "
                         "(loop='pallas', media_pass='compact', sky + media enabled)")

    skies = {}

    def sky_on(device):
        if sky is not None and device not in skies:
            skies[device] = sky.to(device)
        return skies.get(device)

    cells = [((i, j), mesh.devices[i, j]) for i in range(ny) for j in range(nx)]
    if compact:
        tile_settings = shard_settings(settings, ny, nx, interleave)
        strips = cstrips = None
        oy_step, ox_step = th, tw
        if interleave:
            sh, sw = _interleave_strips_ss(H, W, ny, nx, ss)
            if sh:
                strips, oy_step = (sh, ny * sh), sh
            if sw:
                cstrips, ox_step = (sw, nx * sw), sw
        return [((i, j), dev, functools.partial(
            _compact_tile_rgba, scene, tile_settings, camera, effects, time, sky_on(dev),
            tw, th, dev, origin=(float(j * ox_step), float(i * oy_step)),
            img_w=W, img_h=H, strips=strips, cstrips=cstrips))
            for (i, j), dev in cells]

    origin, direction, uv_x, uv_y = generate_rays(W, H, camera, effects, mesh.devices[0, 0])
    max_steps = settings.resolved_max_steps(scene)
    kernels = kernel_loop(settings)

    def plane_tile(i: int, j: int, dev: torch.device) -> torch.Tensor:
        def cut(a):
            return a[i * th:(i + 1) * th, j * tw:(j + 1) * tw].contiguous().to(dev)

        if kernels:
            intensity, trans, hit, vel = march_pallas(scene, origin.map(cut),
                                                      direction.map(cut), time, max_steps)
            if sky is not None:
                bg = tile_background(sky_on(dev), vel, effects)
            else:
                zero = torch.zeros_like(trans)
                bg = Vec3(zero, zero, zero)
            hdr = Vec3(*(i_c + torch.where(hit, 0.0, b_c) * trans
                         for i_c, b_c in zip(intensity, bg)))
        else:  # the plain march, as render.pipeline.render_frame runs it
            hdr, _ = render_hdr(scene, origin.map(cut), direction.map(cut),
                                _time_tensor(time, dev), background(sky_on(dev), effects),
                                max_steps=max_steps, loop=settings.loop, chunk=settings.chunk)
        ldr = apply_effects_and_tonemap(hdr, cut(uv_x), cut(uv_y), effects, scene.exposure)
        return pack_rgba8(downsample_box(ldr, ss))

    return [((i, j), dev, functools.partial(plane_tile, i, j, dev)) for (i, j), dev in cells]


def render_frame_sharded(scene: SceneConfig, settings: RenderSettings, mesh: Mesh,
                         camera: CameraState, effects: CameraEffects, time,
                         sky: Optional[Skybox], interleave=False) -> torch.Tensor:
    """Render one frame with the image tiled over `mesh` -> uint8 [H, W, 4]
    on the grid's first device, shard (i, j)'s tile at block (i, j).
    Height and width must divide by the grid's rows and columns. Tiled ==
    untiled bit for bit; with `interleave` (compact branch only) the frame
    is in device-block layout and `reassemble_strips(frame,
    *interleave_params(settings, mesh))` restores image order."""
    ny, nx = mesh.shape
    th, tw = settings.height // ny, settings.width // nx
    programs = _shard_programs(scene, settings, mesh, camera, effects, time, sky,
                               interleave)
    out_dev = mesh.devices[0, 0]
    frame = torch.empty((settings.height, settings.width, 4), dtype=torch.uint8,
                        device=out_dev)
    for (i, j), _, program in programs:
        frame[i * th:(i + 1) * th, j * tw:(j + 1) * tw] = program().to(out_dev)
    return frame


def make_sharded_renderer(scene: SceneConfig, settings: RenderSettings, mesh: Mesh,
                          interleave="auto"):
    """Frame function (camera, effects, time, sky) -> uint8 [H, W, 4] on
    the grid's first device. `interleave`: "auto" (default) strip-
    interleaves whenever the compact branch applies (resolve_interleave);
    True/False force it. Pass every frame through the function's
    `.reassemble(frame)` (host numpy), which restores image order and is
    the identity for contiguous shards."""
    interleave = resolve_interleave(scene, settings, interleave)

    def fn(camera, effects, time, sky):
        return render_frame_sharded(scene, settings, mesh, camera, effects, time, sky,
                                    interleave=interleave)

    def host(frame) -> np.ndarray:
        return frame.cpu().numpy() if isinstance(frame, torch.Tensor) else np.asarray(frame)

    if interleave:
        params = interleave_params(settings, mesh)

        def reassemble(frame):
            return reassemble_strips(host(frame), *params)
    else:
        reassemble = host

    fn.reassemble = reassemble
    return fn
