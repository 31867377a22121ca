"""Segment-replay media compaction: record pass, replay pass, frame
(port of relativisticraytracer_tpu.ops.pallas_compact).

The trajectory of a ray does not depend on the media, and the skip probes
(media/densities.disk_probe_bounds / cloud_probe_bounds) guarantee zero
emission and zero opacity wherever they are False. So the march splits:

  A) the RECORD pass (`march_pallas_camera_sky_record`): ray generation,
     vacuum march, and per ray up to `slots` media segments — PRE-step
     position + velocity at segment entry plus the segment length in steps.
     Segments past the last slot merge into it (the replay then marches
     the probe-false gap steps, which contribute exact zeros). It also
     returns the hit mask and the sky coordinates of the escape direction.
     Segment boundaries are exact per step; the JAX kernel merges gaps
     inside each 40-step block, which replays to the same (I, T), so the
     record planes are not a contract — hit, sky coordinates and the
     replayed (I, T) are.
  B) the REPLAY pass (`media_replay`): each ray re-integrates only its
     recorded segments, back to back, and shades them.

Each pass has a hand-written CUDA kernel (csrc/record.cu, csrc/replay.cu)
and its plain PyTorch version. The wrapper launches the kernel for CUDA
tensors and runs the plain version for CPU tensors; nothing else picks.

The final frame is  hdr = I_B + bg * (0 if captured else T_B)
(raymarcher.cu:123-150), composited in `_compact_tile_rgba`.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from relativisticraytracer_tpu_torch.config import (
    CameraEffects,
    RenderSettings,
    SceneConfig,
)
from relativisticraytracer_tpu_torch.core.vecmath import Vec3, normalize
from relativisticraytracer_tpu_torch.ops import cuda_lib
from relativisticraytracer_tpu_torch.ops.camera_rays import (
    pack_camera_scalars,
    rays_from_scalars,
)
from relativisticraytracer_tpu_torch.ops.pallas_march import _time_tensor, render_frame_pallas
from relativisticraytracer_tpu_torch.ops.pallas_sky import sky_background_windowed
from relativisticraytracer_tpu_torch.render.march import (
    CHUNK,
    _media_contribution,
    adaptive_h,
    compose_step,
    media_probes,
    media_zones,
)
from relativisticraytracer_tpu_torch.physics.integrators import _recenter, rk4_step
from relativisticraytracer_tpu_torch.render.postfx import (
    apply_effects_and_tonemap,
    downsample_box,
    pack_rgba8,
)
from relativisticraytracer_tpu_torch.render.camera import uv_planes
from relativisticraytracer_tpu_torch.render.skybox import Skybox, sky_coords

# Default number of exactly-tracked segments per ray.
SLOTS = 3


class Record(NamedTuple):
    """Record-pass outputs, (H, W) planes with leading channel/slot axes."""

    hit: torch.Tensor    # f32 [H, W], 1.0 where the horizon captured the ray
    idx: torch.Tensor    # i32 [3, H, W] flat quad index per channel (r, g, b)
    fx: torch.Tensor     # f32 [3, H, W]
    fy: torch.Tensor     # f32 [3, H, W]
    rec: torch.Tensor    # f32 [slots, 7, H, W]: px, py, pz, vx, vy, vz, length
    total: torch.Tensor  # f32 [H, W] total recorded length (replay steps)


# --------------------------------------------------------------------------
# A: the record pass
# --------------------------------------------------------------------------


def _record_plain(scene: SceneConfig, scal, width: int, height: int,
                  max_steps: int, slots: int, sky_h: int, sky_w: int,
                  device, **place) -> Record:
    """Plain PyTorch record pass: the masked march of render/march.py with
    the shading block swapped for a per-step segment recorder. Finished
    rays leave the working set every CHUNK steps (exact: rays are
    independent). `place` holds a shard's origin, img_w/img_h, strips and
    cstrips (ops/camera_rays.rays_from_scalars)."""
    origin, rd = rays_from_scalars(scal, width, height, device, **place)
    n = width * height
    p = origin.map(lambda a: a.reshape(-1).clone())
    v = rd.map(lambda a: a.reshape(-1).clone())
    rec = torch.zeros((slots, 7, n), dtype=torch.float32, device=device)
    hit_full = torch.zeros(n, dtype=torch.bool, device=device)
    v_full = torch.stack([v.x, v.y, v.z])
    ids = torch.arange(n, device=device)
    active = torch.ones(n, dtype=torch.bool, device=device)
    hit = torch.zeros(n, dtype=torch.bool, device=device)
    in_seg = torch.zeros(n, dtype=torch.bool, device=device)
    k = torch.zeros(n, dtype=torch.long, device=device)
    entry = torch.zeros(n, dtype=torch.long, device=device)
    eh = scene.event_horizon

    def flush(sel, i):
        """Close the open segments of rays `sel`: their last probing step
        was i-1, so the length is i - entry (merged slots stretch over the
        gap from the last slot's entry)."""
        slot = torch.clamp(k[sel], max=slots) - 1
        rec[slot, 6, ids[sel]] = (i - entry[sel]).to(torch.float32)

    i = 0
    while i < max_steps and ids.numel():
        for _ in range(min(CHUNK, max_steps - i)):
            rel = _recenter(scene, p)
            r2 = rel.x * rel.x + rel.y * rel.y + rel.z * rel.z
            # horizon capture before stepping (captured rays keep their
            # pre-step velocity; h = 0 freezes them)
            hit_now = active & (r2 < (eh * 1.01) ** 2)
            hit = hit | hit_now
            active = active & ~hit_now
            zd, zc = media_zones(scene, rel, r2)
            h = adaptive_h(scene, r2, zd, zc, active)
            pd, pc = media_probes(scene, rel, zd, zc, active)
            probe = torch.zeros_like(active)
            for pr in (pd, pc):
                if pr is not None:
                    probe = probe | pr
            ended = ~probe & in_seg
            if bool(ended.any()):
                flush(ended, i)
            started = probe & ~in_seg
            new_slot = started & (k < slots)
            if bool(new_slot.any()):
                sel = torch.nonzero(new_slot).squeeze(1)
                gid, slot = ids[sel], k[sel]
                for j, c in enumerate((p.x, p.y, p.z, v.x, v.y, v.z)):
                    rec[slot, j, gid] = c[sel]
                entry = torch.where(new_slot, i, entry)
            k = k + started.to(torch.long)
            in_seg = probe
            p_new, v_new = rk4_step(scene, p, v, h)
            outward = rel.x * v_new.x + rel.y * v_new.y + rel.z * v_new.z > 0.0
            active = active & ~((r2 > scene.escape_radius ** 2) & outward)
            p, v = p_new, v_new
            i += 1
        done = ~active & in_seg
        if bool(done.any()):
            flush(done, i)
            in_seg = in_seg & active
        hit_full[ids] = hit
        v_full[:, ids] = torch.stack([v.x, v.y, v.z])
        keep = torch.nonzero(active).squeeze(1)
        ids, active, hit, in_seg, k, entry = (
            a[keep] for a in (ids, active, hit, in_seg, k, entry))
        p, v = p.map(lambda a: a[keep]), v.map(lambda a: a[keep])
    if bool(in_seg.any()):  # open at the step cap
        flush(in_seg, i)

    d = normalize(Vec3(v_full[0], v_full[1], v_full[2]))
    ca_eff = float(scal[15])
    coords = sky_coords(d, ca_eff, sky_h, sky_w)
    shape = (height, width)
    return Record(
        hit=hit_full.to(torch.float32).reshape(shape),
        idx=torch.stack([c[0] for c in coords]).reshape((3,) + shape),
        fx=torch.stack([c[1] for c in coords]).reshape((3,) + shape),
        fy=torch.stack([c[2] for c in coords]).reshape((3,) + shape),
        rec=rec.reshape((slots, 7) + shape),
        total=rec[:, 6].sum(dim=0).reshape(shape),
    )


def _record_cuda(scene: SceneConfig, scal, width: int, height: int,
                 max_steps: int, slots: int, sky_h: int, sky_w: int,
                 device, lib, **place) -> Record:
    lib = cuda_lib.resolve(lib)
    shape = (height, width)
    f32 = dict(dtype=torch.float32, device=device)
    out = Record(
        hit=torch.empty(shape, **f32),
        idx=torch.empty((3,) + shape, dtype=torch.int32, device=device),
        fx=torch.empty((3,) + shape, **f32),
        fy=torch.empty((3,) + shape, **f32),
        rec=torch.empty((slots, 7) + shape, **f32),
        total=torch.empty(shape, **f32),
    )
    lib.record(cuda_lib.scene_consts(scene), cuda_lib.cam_scalars(scal),
               cuda_lib.ray_grid(width, height, **place),
               width, height, max_steps, slots, sky_h, sky_w,
               out.hit, out.idx, out.fx, out.fy, out.rec, out.total,
               cuda_lib.current_stream(device))
    return out


def march_pallas_camera_sky_record(
    scene: SceneConfig,
    camera,
    effects: CameraEffects,
    time,
    width: int,
    height: int,
    max_steps: int,
    sky_h: int,
    sky_w: int,
    slots: int = SLOTS,
    *,
    device="cuda",
    lib=None,
    origin=None,
    img_w: Optional[int] = None,
    img_h: Optional[int] = None,
    strips: Optional[Tuple[int, int]] = None,
    cstrips: Optional[Tuple[int, int]] = None,
) -> Record:
    """The A pass on `device`: csrc/record.cu for a CUDA device, the plain
    PyTorch version on the CPU. `lib` picks a kernel build
    (ops/cuda_lib.kernels); None is the default build.

    A shard of a spatially tiled frame (parallel/sharding.py) marches the
    (height, width) rectangle whose top-left global pixel is
    `origin=(x0, y0)` of an (img_h, img_w) frame, its rows and columns
    optionally strip-interleaved by `strips=(sh, ystride)` and
    `cstrips=(sw, xstride)`; its rays are bitwise the full frame's."""
    device = torch.device(device)
    if slots < 1:
        raise ValueError(f"slots must be >= 1, got {slots}")
    if (origin is None) != (img_w is None or img_h is None):
        raise ValueError("origin and img_w/img_h must be given together")
    scal = pack_camera_scalars(camera, effects, time)
    args = (scene, scal, width, height, max_steps, slots, sky_h, sky_w, device)
    place = dict(origin=origin, img_w=img_w, img_h=img_h, strips=strips, cstrips=cstrips)
    if device.type == "cuda":
        return _record_cuda(*args, lib, **place)
    if device.type == "cpu":
        return _record_plain(*args, **place)
    raise ValueError(f"unsupported device {device}")


# --------------------------------------------------------------------------
# B: the replay pass
# --------------------------------------------------------------------------


def _replay_step(scene: SceneConfig, p: Vec3, v: Vec3, intensity: Vec3, trans,
                 steps_left, t):
    """One replay step: the march step's h/RK4/shading path restricted to
    what can happen inside a recorded span (no horizon or escape there).
    Each medium's block runs only on rays whose probe is True (exact)."""
    active = steps_left > 0.0
    rel = _recenter(scene, p)
    r2 = rel.x * rel.x + rel.y * rel.y + rel.z * rel.z
    zd, zc = media_zones(scene, rel, r2)
    h = adaptive_h(scene, r2, zd, zc, active)
    pd, pc = media_probes(scene, rel, zd, zc, active)
    p, v = rk4_step(scene, p, v, h)
    in_media = active & (zd | zc)
    emit, opacity = _media_contribution(scene, rel, r2, v, zd, zc, t,
                                        probe_disk=pd, probe_cloud=pc)
    intensity, trans = compose_step(intensity, trans, emit.x, emit.y, emit.z,
                                    opacity, in_media, h)
    return p, v, intensity, trans, steps_left - active.to(torch.float32)


def _replay_plain(scene: SceneConfig, rec: torch.Tensor, time,
                  sel: torch.Tensor):
    """Plain replay of the rays `sel` (flat pixel indices): slot after slot,
    each ray marching its recorded steps. Returns (I [3, m], T [m]) in the
    order of `sel`.

    The rays are marched in pixel order whatever the order of `sel`: torch's
    CPU kernels evaluate exp/pow/sin/cos with SIMD code on whole vectors and
    with scalar libm code on the tail, so a ray's last ulp would otherwise
    depend on its place in the batch (the kernel's threads do not share)."""
    perm = torch.argsort(sel)
    inten, trans = _replay_plain_sorted(scene, rec, time, sel[perm])
    out_i, out_t = torch.empty_like(inten), torch.empty_like(trans)
    out_i[:, perm], out_t[perm] = inten, trans
    return out_i, out_t


def _replay_plain_sorted(scene: SceneConfig, rec: torch.Tensor, time,
                         sel: torch.Tensor):
    slots = rec.shape[0]
    flat = rec.reshape(slots, 7, -1)
    t = _time_tensor(time, rec.device)
    m = sel.numel()
    inten = torch.zeros((3, m), dtype=torch.float32, device=rec.device)
    trans = torch.ones(m, dtype=torch.float32, device=rec.device)
    for s in range(slots):
        live = torch.nonzero(flat[s, 6, sel] > 0.0).squeeze(1)
        if live.numel() == 0:
            break  # slots fill in order: no ray has a later one
        src = flat[s][:, sel[live]]
        p = Vec3(src[0], src[1], src[2])
        v = Vec3(src[3], src[4], src[5])
        left = src[6]
        inten_s = Vec3(inten[0, live], inten[1, live], inten[2, live])
        trans_s = trans[live]
        while live.numel():
            for _ in range(CHUNK):
                p, v, inten_s, trans_s, left = _replay_step(
                    scene, p, v, inten_s, trans_s, left, t)
            inten[:, live] = torch.stack(list(inten_s))
            trans[live] = trans_s
            keep = torch.nonzero(left > 0.0).squeeze(1)
            live, left, trans_s = live[keep], left[keep], trans_s[keep]
            p, v, inten_s = (a.map(lambda c: c[keep]) for a in (p, v, inten_s))
    return inten, trans


def replay_order(total: torch.Tensor) -> torch.Tensor:
    """The rays to replay, longest replay first: int32 flat pixel indices
    of total > 0, sorted by total length descending (ties in pixel order).
    Takes the place of the JAX package's row compaction and static
    `media_capacity` buffer (pallas_compact.py:674-744); `nonzero` waits
    for the device."""
    flat = total.reshape(-1)
    idx = torch.nonzero(flat > 0.0).squeeze(1)
    order = torch.argsort(flat[idx], descending=True, stable=True)
    return idx[order].to(torch.int32)


def media_replay(
    scene: SceneConfig,
    rec: torch.Tensor,
    time,
    order: Optional[torch.Tensor] = None,
    lib=None,
) -> Tuple[Vec3, torch.Tensor]:
    """The B pass: replay recorded media segments. `rec` is the record
    pass's [slots, 7, H, W] planes; `order` the int32 flat pixel indices
    to replay (None: every pixel, in image order). Returns (intensity Vec3,
    transmittance), [H, W]; pixels not replayed get I = 0, T = 1 — what
    replaying their empty records gives. csrc/replay.cu for CUDA tensors,
    the plain version for CPU tensors."""
    if rec.dim() != 4 or rec.shape[1] != 7:
        raise ValueError(f"records must be [slots, 7, H, W], got {tuple(rec.shape)}")
    slots, _, h, w = rec.shape
    n = h * w
    device = rec.device
    if order is None:
        order = torch.arange(n, dtype=torch.int32, device=device)
    if order.dtype != torch.int32 or order.dim() != 1 or order.device != device:
        raise ValueError("order must be a 1-D int32 tensor on the records' device")
    if device.type == "cuda":
        inten = torch.zeros((3, h, w), dtype=torch.float32, device=device)
        trans = torch.ones((h, w), dtype=torch.float32, device=device)
        cuda_lib.resolve(lib).replay(
            cuda_lib.scene_consts(scene), float(time), n, order.numel(), slots,
            rec, order, inten, trans, cuda_lib.current_stream(device))
    elif device.type == "cpu":
        sel = order.to(torch.long)
        inten = torch.zeros((3, n), dtype=torch.float32)
        trans = torch.ones(n, dtype=torch.float32)
        inten[:, sel], trans[sel] = _replay_plain(scene, rec, time, sel)
        inten, trans = inten.reshape(3, h, w), trans.reshape(h, w)
    else:
        raise ValueError(f"unsupported device {device}")
    return Vec3(inten[0], inten[1], inten[2]), trans


def media_replay_sorted(scene: SceneConfig, record: Record, time,
                        lib=None) -> Tuple[Vec3, torch.Tensor]:
    """The B pass over the rays that recorded media only, longest first,
    so each warp holds rays of similar replay length. A ray's replay
    depends only on its own records, so this is bitwise the image-layout
    replay."""
    return media_replay(scene, record.rec, time,
                        order=replay_order(record.total), lib=lib)


# --------------------------------------------------------------------------
# Full-frame pipeline
# --------------------------------------------------------------------------


def _compact_tile_rgba(
    scene: SceneConfig,
    settings: RenderSettings,
    camera,
    effects: CameraEffects,
    time,
    sky: Skybox,
    w: int,
    h: int,
    device,
    lib=None,
    origin=None,
    img_w: Optional[int] = None,
    img_h: Optional[int] = None,
    strips: Optional[Tuple[int, int]] = None,
    cstrips: Optional[Tuple[int, int]] = None,
) -> torch.Tensor:
    """uint8 RGBA [h, w, 4] of the (supersampled) rectangle before the SSAA
    resolve: record, replay, sky, composite and epilogue.

    Single device: origin=None and (w, h) is the frame. A shard
    (parallel/sharding.py): `origin=(x0, y0)` is the global pixel of its
    rectangle in the (img_h, img_w) supersampled frame, and `strips` /
    `cstrips` its strip maps; ray gen, sky addressing and the vignette uv
    all use global coordinates, so the tile is bitwise the matching crop
    of the single-device frame, rows and columns in local order."""
    ss = settings.supersample
    place = dict(origin=origin, img_w=img_w, img_h=img_h, strips=strips, cstrips=cstrips)
    record = march_pallas_camera_sky_record(
        scene, camera, effects, time, w, h, settings.resolved_max_steps(scene),
        *sky.shape, slots=settings.media_slots, device=device, lib=lib, **place,
    )
    if settings.media_sort:
        intensity, trans = media_replay_sorted(scene, record, time, lib=lib)
    else:
        intensity, trans = media_replay(scene, record.rec, time, lib=lib)

    # Captured rays: transmittance 0 (raymarcher.cu:49) — the replay
    # cannot know about captures, so the mask applies here.
    captured = record.hit > 0.5
    trans = torch.where(captured, 0.0, trans)
    bg = sky_background_windowed(sky, record.idx, record.fx, record.fy,
                                 effects, masked=captured, lib=lib)
    hdr = Vec3(
        intensity.x + bg.x * trans,
        intensity.y + bg.y * trans,
        intensity.z + bg.z * trans,
    )
    uv_x, uv_y = uv_planes(w, h, effects, device, **place)
    ldr = apply_effects_and_tonemap(hdr, uv_x, uv_y, effects, scene.exposure)
    return pack_rgba8(downsample_box(ldr, ss))


def render_frame_pallas_compact(
    scene: SceneConfig,
    settings: RenderSettings,
    camera,
    effects: CameraEffects,
    time,
    sky: Optional[Skybox],
    *,
    device="cuda",
    lib=None,
) -> torch.Tensor:
    """The default frame program on `device`: uint8 [H, W, 4].

    Record + replay needs a sky and a medium; without either the frame
    goes to the fused inline march, as in the JAX package
    (pallas_compact.py:872-874)."""
    if sky is None or not (scene.enable_disk or scene.enable_clouds):
        return render_frame_pallas(scene, settings, camera, effects, time, sky,
                                   device=device, lib=lib)
    ss = settings.supersample
    return _compact_tile_rgba(scene, settings, camera, effects, time, sky,
                              settings.width * ss, settings.height * ss,
                              device, lib)
