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
     recorded segments, back to back, and shades them. On the card it runs
     as three passes over a step list in device memory (csrc/replay.cu):
     march (one thread per recorded segment, in the plan's segment order,
     longest first: each step's pre-step rel and post-step v), shade (one thread per step: disk, then cloud, the last
     one also the step's transmittance) and composite (one thread per ray,
     its steps in order). A ray's offset is the exclusive prefix sum of
     the listed rays' lengths (`step_offsets`). The list is allocated at a
     capacity fixed on the host (`step_capacity`, at most STEP_BUDGET
     entries), and the passes run in rounds over it: each round replays
     the next rays whose steps fit it, from the round's base offset. The
     list order, the offsets, the counts and the round table are built on
     the device (`replay_plan`): no launch waits for the device. The rays
     longer than the list and those past the last round are replayed by a
     per-ray kernel, so the frame is exact for every pose.

Each pass has a hand-written CUDA kernel (csrc/record.cu, csrc/replay.cu)
and its plain PyTorch version (`_record_plain`, `_replay_plain`, which is
also the twin of the per-ray overflow kernel). The wrapper launches the
kernel for CUDA tensors and runs the plain version for CPU tensors; nothing
else picks. The replay's three passes also have plain twins
(`_replay_passes_plain`), which run the step-list layout on the CPU.

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
        rec=torch.zeros((slots, 7) + shape, **f32),  # one memset; threads write records only
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


# Replay lengths are integers below 2^24 (exact in float32): the order key's
# length field, and no ray is longer than a list of this many entries.
_LEN_LIMIT = 1 << 24
# The step list's budget: at most 2^27 entries (5.4 GB at 40 B a step) for
# a frame of any size, at least a 1080p list of 64 steps a pixel
# (132,710,400 entries). The default camera paths, sampled each second at
# three sizes (tools/replay_traffic.py, PERF.md), need 5.4 to 399 steps a
# pixel: at most 827.9M steps a frame at 1080p, 268.0M at 1000x700 and
# 52.1M at 480x272. 2^27 holds every 480x272 frame and all but 4 of the
# 1000x700 and 19 of the 1080p ones in one round; a list of 64 steps a
# pixel would take 21 GB at 3840x2160 and 85 GB at 7680x4320, more than
# the card's 80 GB.
STEP_BUDGET = 1 << 27
# Rounds of the replay passes over the list, at most: the surveyed 1080p
# frames need 1 to 7 (827.9M steps fill 6.2 lists). Rays past the last
# round take the per-ray kernel. Over the 63 surveyed frames that
# overflowed a list of 64 steps a pixel, it took a median 1.24x the passes'
# time a step: 0.88x at 1080p, where many rays fill the card, and 3.7x
# (1.5-7.4x) at 480x272, where few rays fill under a wave.
ROUNDS = 7


class ReplayPlan(NamedTuple):
    """The replay's bookkeeping, built on the device (`replay_plan`)."""

    order: torch.Tensor    # int32 [L] flat pixels, the listed rays first
    offsets: torch.Tensor  # int64 [L] each ray's first entry in the step list
    # int64 [4] on the device: m listed rays, m_r of them replayed by the
    # rounds, S steps of the listed rays, S_r of them in the rounds
    counts: torch.Tensor
    # int64 [R, 4] on the device, one row a round: its first listed ray, its
    # rays, its base (the first ray's offset) and its steps
    rounds: torch.Tensor
    capacity: int          # entries of the step list
    # The march pass's segment order (`with_segments`): int32
    # [L * slots, 2], each round's non-empty (listed ray, slot) segments,
    # longest first, ties in (ray, slot) order, round after round, as (list
    # start less the round's base, pixel * slots + slot); entries past the
    # rounds' segments are unwritten. segment_counts: int64 [R] a round's.
    segments: Optional[torch.Tensor] = None
    segment_counts: Optional[torch.Tensor] = None


def step_capacity(pixels: int, max_steps: Optional[int] = None) -> int:
    """Entries of the replay's step list for a frame of `pixels` rays: what
    the frame can need (`max_steps` a pixel; None: the longest a record
    holds), at most STEP_BUDGET. Fixed on the host, so the list is
    allocated without a host sync."""
    longest = _LEN_LIMIT if max_steps is None else max_steps
    return max(min(pixels * longest, STEP_BUDGET), 1)


def replay_rounds(pixels: int, max_steps: Optional[int], capacity: int) -> int:
    """Rounds a frame of `pixels` rays of at most `max_steps` steps (None:
    unknown) can need over a list of `capacity` entries, at most ROUNDS.
    A round that is not the last holds more than capacity - max_steps
    steps (the next ray did not fit), so 1 + ceil((S - capacity) /
    (capacity - max_steps + 1)) rounds hold S steps. On the host: a small
    frame launches no round that must be empty."""
    longest = _LEN_LIMIT if max_steps is None else max_steps
    if capacity < longest:
        return ROUNDS
    rest = max(pixels * longest - capacity, 0)
    return min(ROUNDS, 1 + -(-rest // (capacity - longest + 1)))


def replay_plan(total: torch.Tensor, capacity: int, order: Optional[torch.Tensor] = None,
                rounds: int = ROUNDS, lib=None) -> ReplayPlan:
    """The replay's list, on `total`'s device without a host sync.

    `order` None: every pixel, longest replay first, ties in pixel order —
    the sort key (2^24 - length) * N + pixel is unique, so the order does
    not depend on the sort being stable — and the rays with a replay
    (length > 0) are the m listed ones; the rest follow with length 0.
    Otherwise `order` (int32 flat pixels) is the list and every entry is
    listed, the rays longer than `capacity` moved to its front. Offsets are
    the exclusive prefix sums of the lengths along the list. The rays
    longer than the list are a prefix of it (longest first); from there
    `rounds` rounds each take the next rays whose steps fit `capacity`
    (`_replay_rounds_plain`; on the card csrc/replay.cu's rounds kernel,
    `lib` as in `media_replay`). `with_segments` adds the march pass's
    segment order."""
    flat = total.reshape(-1)
    lengths = flat.to(torch.int64)  # integers below 2^24: exact
    if order is None:
        n = flat.numel()
        key = (_LEN_LIMIT - lengths) * n + torch.arange(n, device=flat.device)
        order = torch.argsort(key)
        listed = (lengths > 0).sum()
    else:
        order = order.long()
        if capacity < _LEN_LIMIT:  # a ray may be longer than the list
            order = order[torch.argsort((lengths[order] <= capacity).to(torch.int8), stable=True)]
        listed = torch.full((), order.numel(), dtype=torch.int64, device=flat.device)
    lengths = lengths[order]
    csum = torch.empty(lengths.numel() + 1, dtype=torch.int64, device=flat.device)
    csum[:1].zero_()
    torch.cumsum(lengths, 0, out=csum[1:])
    if flat.device.type == "cuda":
        table = torch.empty((rounds, 4), dtype=torch.int64, device=flat.device)
        counts = torch.empty(4, dtype=torch.int64, device=flat.device)
        cuda_lib.resolve(lib).replay_rounds(csum, listed, capacity, table, counts,
                                            cuda_lib.current_stream(flat.device))
    else:
        table, counts = _replay_rounds_plain(csum, listed, capacity, rounds)
    return ReplayPlan(order.to(torch.int32), csum[:-1], counts, table, capacity)


def segment_len_bits(capacity: int, max_steps: Optional[int]) -> int:
    """Bits of a segment's length in the segment order's key: a segment of
    a round is at most its ray's steps, so at most the list's capacity, the
    record's step cap and 2^24 - 1."""
    longest = min(capacity, _LEN_LIMIT - 1, _LEN_LIMIT if max_steps is None else max_steps)
    return max(longest, 1).bit_length()


def with_segments(plan: ReplayPlan, rec: torch.Tensor, max_steps: Optional[int] = None,
                  lib=None) -> ReplayPlan:
    """`plan` with the march pass's segment order (ReplayPlan.segments and
    segment_counts) of the records `rec` it was built from: the rounds'
    non-empty segments sorted by (round, longest first), ties in (listed
    ray, slot) order, each as (its list start less the round's base, pixel
    * slots + slot). `max_steps`: the record's step cap (None: unknown),
    which bounds a segment's length. On the card csrc/replay.cu's segment
    kernels (a stable radix sort that reads its counts on the device: no
    host sync); on the CPU `_segment_order_plain`."""
    slots = rec.shape[0]
    if rec.dim() != 4 or rec.shape[1] != 7:
        raise ValueError(f"records must be [slots, 7, H, W], got {tuple(rec.shape)}")
    if plan.capacity >= 1 << 31 or plan.order.numel() * slots >= 1 << 31:
        raise ValueError("the segment order holds list starts and pixel * slots in int32")
    bits = segment_len_bits(plan.capacity, max_steps)
    if rec.device.type == "cuda":
        segments, counts = cuda_lib.resolve(lib).replay_segments(
            rec, plan.order, plan.offsets, plan.rounds, bits, cuda_lib.current_stream(rec.device))
    else:
        segments, counts = _segment_order_plain(rec, plan.order, plan.offsets, plan.rounds, bits)
    return plan._replace(segments=segments, segment_counts=counts)


def _segment_order_plain(rec: torch.Tensor, order: torch.Tensor, offsets: torch.Tensor,
                         table: torch.Tensor, len_bits: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain twin of csrc/replay.cu's segment kernels: (segments int32
    [L * slots, 2], counts int64 [R]), the entries past the rounds'
    segments -1. The segments of the rays in rounds ([round 0's first ray,
    the last round's end) along the list) sorted by the unique key (round,
    2^len_bits - 1 - length saturated at 0, ray, slot)."""
    slots = rec.shape[0]
    rows = table.tolist()
    lo, hi = rows[0][0], rows[-1][0] + rows[-1][1]
    pix = order[lo:hi].long()
    lens = rec[:, 6].reshape(slots, -1)[:, pix].to(torch.int64).T  # [rays, slots]
    ends = torch.tensor([r[0] + r[1] for r in rows], dtype=torch.int64)
    bases = torch.tensor([r[2] for r in rows], dtype=torch.int64)
    k = torch.searchsorted(ends, torch.arange(lo, hi), right=True)  # each ray's round
    start = (offsets[lo:hi] - bases[k])[:, None] + torch.cumsum(lens, 1) - lens
    field = torch.clamp((1 << len_bits) - 1 - lens, min=0)
    items = lens.numel()
    key = (((k[:, None] << len_bits) | field) * items
           + torch.arange(items, dtype=torch.int64).reshape(lens.shape))
    seg = lens > 0
    perm = torch.argsort(key[seg])
    packed = pix[:, None] * slots + torch.arange(slots)
    out = torch.full((order.numel() * slots, 2), -1, dtype=torch.int32)
    out[:perm.numel()] = torch.stack([start[seg], packed[seg]], 1)[perm].to(torch.int32)
    counts = torch.bincount(k[:, None].expand(lens.shape)[seg], minlength=len(rows))
    return out, counts.to(torch.int64)


def _replay_rounds_plain(csum: torch.Tensor, listed: torch.Tensor, capacity: int,
                         rounds: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain twin of csrc/replay.cu::replay_rounds_kernel: the round table
    [rounds, 4] and the counts [4] (ReplayPlan), int64. `csum` [L + 1] is 0
    and then the listed rays' step ends along the list; the first `listed`
    rays are listed, those longer than `capacity` first. Round k starts at
    the first ray that no earlier round took, its base that ray's offset,
    and takes the rays whose steps end within base + capacity."""
    m = int(listed)
    ends = csum[1:m + 1]
    j = int((ends - csum[:m] > capacity).sum())  # the rays longer than the list
    table = []
    for _ in range(rounds):
        base = int(csum[j])
        nxt = int(torch.searchsorted(ends, base + capacity, right=True))
        table.append([j, nxt - j, base, int(csum[nxt]) - base])
        j = nxt
    table = torch.tensor(table, dtype=torch.int64, device=csum.device).reshape(rounds, 4)
    counts = torch.stack([listed.to(torch.int64).reshape(()), table[:, 1].sum(), csum[m],
                          table[:, 3].sum()])
    return table, counts


def replay_list(total: torch.Tensor) -> Tuple[torch.Tensor, int]:
    """(order, n_steps) of `replay_plan`'s sorted list read on the host:
    the m listed rays (int32, longest first) and their steps. It waits for
    the device, so the frame path never calls it."""
    plan = replay_plan(total, 1, rounds=1)
    m, _, n_steps, _ = plan.counts.tolist()
    return plan.order[:m], n_steps


def replay_order(total: torch.Tensor) -> torch.Tensor:
    """The rays to replay, longest replay first (see `replay_list`)."""
    return replay_list(total)[0]


def step_lengths(rec: torch.Tensor, order: torch.Tensor) -> torch.Tensor:
    """int64 [m]: each listed ray's replay length, its slots' lengths
    summed (integers below 2^24, so the float sum is exact)."""
    slots = rec.shape[0]
    return rec[:, 6].reshape(slots, -1)[:, order.long()].sum(0).to(torch.int64)


def step_offsets(lengths: torch.Tensor) -> torch.Tensor:
    """Each listed ray's first entry in the step list: the exclusive prefix
    sum of the lengths, on the device."""
    return torch.cumsum(lengths, 0) - lengths


def _replay_cuda(scene: SceneConfig, rec: torch.Tensor, time, plan: ReplayPlan, lib):
    """csrc/replay.cu: the three passes (four launches) over a step list of
    `plan.capacity` entries, once a round of `plan.rounds` (a round with no
    rays reads its row and exits), then the per-ray kernel for the rays
    longer than the list or past the last round. Returns (I [3, H, W],
    T [H, W]); nothing waits for the device."""
    lib = cuda_lib.resolve(lib)
    _, _, h, w = rec.shape
    device = rec.device
    inten = torch.zeros((3, h, w), dtype=torch.float32, device=device)
    trans = torch.ones((h, w), dtype=torch.float32, device=device)
    consts, stream = cuda_lib.scene_consts(scene), cuda_lib.current_stream(device)
    pos, vel, emit = step_list(plan.capacity, device)
    for r in range(plan.rounds.shape[0]):
        replay_round(lib, consts, scene, time, rec, plan, r, pos, vel, emit, inten, trans, stream)
    lib.replay_overflow(consts, float(time), rec, plan, inten, trans, stream)
    return inten, trans


def replay_round(lib, consts, scene: SceneConfig, time, rec: torch.Tensor, plan: ReplayPlan,
                 r: int, pos, vel, emit, inten, trans, stream) -> None:
    """Round `r` of the replay's passes on the card: march, shade disk (every
    step), shade cloud, composite over the step list (pos, vel, emit)."""
    lib.replay_march(consts, rec, plan, r, pos, vel, stream)
    lib.replay_shade(consts, float(time), "disk", plan, r, pos, vel, emit, stream)
    if scene.enable_clouds:
        lib.replay_shade(consts, float(time), "cloud", plan, r, pos, vel, emit, stream)
    lib.replay_composite(plan, r, emit, inten, trans, stream)


def step_list(n_steps: int, device):
    """The replay kernels' step list, uninitialised: pos [S, 4] (PRE-step
    rel, POST-step v.x), vel [S, 2] (v.y, v.z) and emit [S, 4] (r, g, b,
    the step's transmittance)."""
    f32 = dict(dtype=torch.float32, device=device)
    return (torch.empty((n_steps, 4), **f32), torch.empty((n_steps, 2), **f32),
            torch.empty((n_steps, 4), **f32))


# Plain twins of the three passes (CPU bookkeeping tests; the CPU replay
# itself is `_replay_plain`).


def _replay_march_plain(scene: SceneConfig, rec: torch.Tensor, sel: torch.Tensor,
                        offsets: torch.Tensor, n_steps: int):
    """Pass 1: (pos [S, 4], vel [S, 2]) — every replayed step's PRE-step
    rel and POST-step v (pos holds rel and v.x, vel v.y and v.z), each
    recorded segment of the listed rays (`sel`, flat pixels) from its ray's
    offset plus its earlier slots' lengths. Entries no segment writes stay
    NaN, so a ray whose bookkeeping reads one shows it."""
    slots = rec.shape[0]
    flat = rec.reshape(slots, 7, -1)
    pos, vel = _nan_list(n_steps, rec.device)
    start = offsets.clone()
    for s in range(slots):
        src = flat[s][:, sel]
        _march_segments(scene, src, start, pos, vel)
        start = start + src[6].to(torch.int64)
    return pos, vel


def _replay_march_segments_plain(scene: SceneConfig, rec: torch.Tensor, plan: ReplayPlan,
                                 r: int):
    """Plain twin of csrc/replay.cu::replay_march_kernel: (pos, vel) of
    round `r`'s step list (the round's steps; entries no segment writes stay
    NaN), each of the round's segments in the plan's segment order marched
    from its list start."""
    slots, n = rec.shape[0], rec.shape[2] * rec.shape[3]
    counts = plan.segment_counts.tolist()
    first = sum(counts[:r])
    seg = plan.segments[first:first + counts[r]].long()
    pos, vel = _nan_list(plan.rounds[r, 3].item(), rec.device)
    src = rec.reshape(slots, 7, n)[seg[:, 1] % slots, :, seg[:, 1] // slots].T  # [7, segments]
    _march_segments(scene, src, seg[:, 0], pos, vel)
    return pos, vel


def _nan_list(n_steps: int, device):
    """(pos [S, 4], vel [S, 2]) of NaN: a step list no segment wrote yet."""
    f32 = dict(dtype=torch.float32, device=device)
    return (torch.full((n_steps, 4), float("nan"), **f32),
            torch.full((n_steps, 2), float("nan"), **f32))


def _march_segments(scene: SceneConfig, src: torch.Tensor, at: torch.Tensor, pos: torch.Tensor,
                    vel: torch.Tensor) -> None:
    """March segments of recorded state `src` [7, k] (PRE-step p, v and the
    length) from list entries `at` [k] on, each step by step while it has
    steps left (an empty one marches nothing), writing each step's PRE-step
    rel and POST-step v to `pos` and `vel`."""
    p, v = Vec3(src[0], src[1], src[2]), Vec3(src[3], src[4], src[5])
    left = src[6]
    while True:
        keep = torch.nonzero(left > 0.0).squeeze(1)
        if not keep.numel():
            return
        at, left = at[keep], left[keep]
        p, v = (a.map(lambda c: c[keep]) for a in (p, v))
        rel = _recenter(scene, p)
        r2 = rel.x * rel.x + rel.y * rel.y + rel.z * rel.z
        zd, zc = media_zones(scene, rel, r2)
        h = adaptive_h(scene, r2, zd, zc, torch.ones_like(zd))
        p, v = rk4_step(scene, p, v, h)
        pos[at] = torch.stack([rel.x, rel.y, rel.z, v.x], dim=1)
        vel[at] = torch.stack([v.y, v.z], dim=1)
        at, left = at + 1, left - 1.0


def _replay_shade_plain(scene: SceneConfig, pos: torch.Tensor, vel: torch.Tensor,
                        time) -> torch.Tensor:
    """Pass 2: emit [S, 4] — each step's emission (r, g, b), disk then
    cloud under its probes (zeros where both are False), and its
    transmittance exp(-(opacity * h)) (render/march.compose_step)."""
    rel, v = Vec3(pos[:, 0], pos[:, 1], pos[:, 2]), Vec3(pos[:, 3], vel[:, 0], vel[:, 1])
    r2 = rel.x * rel.x + rel.y * rel.y + rel.z * rel.z
    zd, zc = media_zones(scene, rel, r2)
    pd, pc = media_probes(scene, rel, zd, zc, torch.ones_like(zd))
    emit, op = _media_contribution(scene, rel, r2, v, zd, zc, _time_tensor(time, pos.device),
                                   probe_disk=pd, probe_cloud=pc)
    h = adaptive_h(scene, r2, zd, zc, torch.ones_like(zd))
    return torch.stack([emit.x, emit.y, emit.z, torch.exp(-(op * h))], dim=1)


def _replay_composite_plain(emit: torch.Tensor, offsets: torch.Tensor):
    """Pass 3: (I [3, m], T [m]) — each listed ray composites its steps
    [offsets[j], offsets[j+1]) in order (render/march.compose_step)."""
    lengths = torch.diff(offsets, append=offsets.new_tensor([emit.shape[0]]))
    m = offsets.numel()
    inten = torch.zeros((3, m), dtype=torch.float32, device=emit.device)
    trans = torch.ones(m, dtype=torch.float32, device=emit.device)
    for j in range(int(lengths.max()) if m else 0):
        live = torch.nonzero(lengths > j).squeeze(1)
        e = emit[offsets[live] + j]
        factor = (1.0 - e[:, 3]) * trans[live]
        inten[:, live] = inten[:, live] + e[:, :3].T * factor
        trans[live] = trans[live] * e[:, 3]
    return inten, trans


def _replay_passes_plain(scene: SceneConfig, rec: torch.Tensor, time, sel: torch.Tensor):
    """The three passes composed, as the kernels run them: (I [3, m],
    T [m]) of the rays `sel` in its order, as `_replay_plain` returns."""
    sel = sel.long()
    lengths = step_lengths(rec, sel)
    offsets = step_offsets(lengths)
    pos, vel = _replay_march_plain(scene, rec, sel, offsets, int(lengths.sum()))
    return _replay_composite_plain(_replay_shade_plain(scene, pos, vel, time), offsets)


def media_replay(
    scene: SceneConfig,
    rec: torch.Tensor,
    time,
    order: Optional[torch.Tensor] = None,
    lib=None,
    capacity: Optional[int] = None,
    max_steps: Optional[int] = None,
) -> Tuple[Vec3, torch.Tensor]:
    """The B pass: replay recorded media segments. `rec` is the record
    pass's [slots, 7, H, W] planes; `order` the int32 flat pixel indices
    to replay (None: every pixel, in image order). Returns (intensity Vec3,
    transmittance), [H, W]; pixels not replayed get I = 0, T = 1 — what
    replaying their empty records gives. csrc/replay.cu for CUDA tensors,
    the plain version for CPU tensors. `capacity`: the step list's entries
    (None: `step_capacity` of the frame); the passes run in rounds over it,
    and the rays longer than it or past the last round are replayed one
    thread a ray, with the same (I, T). `max_steps`: the record's step cap
    (None: unknown), which bounds the list and its rounds (`replay_rounds`)."""
    if rec.dim() != 4 or rec.shape[1] != 7:
        raise ValueError(f"records must be [slots, 7, H, W], got {tuple(rec.shape)}")
    n = rec.shape[2] * rec.shape[3]
    if order is None:
        order = torch.arange(n, dtype=torch.int32, device=rec.device)
    if order.dtype != torch.int32 or order.dim() != 1 or order.device != rec.device:
        raise ValueError("order must be a 1-D int32 tensor on the records' device")
    total = rec[:, 6].sum(0)  # integers below 2^24: exact in any order
    cap = step_capacity(n, max_steps) if capacity is None else capacity
    plan = replay_plan(total, cap, order, replay_rounds(n, max_steps, cap), lib)
    return _replay(scene, rec, time, with_segments(plan, rec, max_steps, lib), lib)


def _replay(scene: SceneConfig, rec: torch.Tensor, time, plan: ReplayPlan,
            lib) -> Tuple[Vec3, torch.Tensor]:
    """(I, T) [H, W] of `plan`'s listed rays: the kernels for CUDA tensors;
    on the CPU the same split with the plain versions: the passes' twins
    over the step list, round by round, `_replay_plain` (the per-ray
    kernel's twin) for the rest."""
    _, _, h, w = rec.shape
    device = rec.device
    if plan.segments is None:
        raise ValueError("the replay plan has no segment order (with_segments)")
    if device.type == "cuda":
        inten, trans = _replay_cuda(scene, rec, time, plan, lib)
    elif device.type == "cpu":
        inten, trans = _replay_split_plain(scene, rec, time, plan)
        inten, trans = inten.reshape(3, h, w), trans.reshape(h, w)
    else:
        raise ValueError(f"unsupported device {device}")
    return Vec3(inten[0], inten[1], inten[2]), trans


def _replay_split_plain(scene: SceneConfig, rec: torch.Tensor, time, plan: ReplayPlan):
    """The kernels' split on CPU tensors: (I [3, N], T [N]). Each round of
    `plan.rounds` runs the three passes' twins over a step list of its
    steps (at most the capacity): the march over the round's segments in
    the plan's segment order, each from its list start, then shade and
    composite over its rays, each at its offset less the round's base; the
    rays before round 0 (longer than the list) and past the last round run
    through `_replay_plain`.

    The shade twin takes the list's steps in pixel order, each ray's steps
    in turn: torch's CPU transcendentals round an element by its place in
    the batch, and this keeps a ray's bits independent of the list order
    (the kernels' threads do not share)."""
    n = rec.shape[2] * rec.shape[3]
    order = plan.order.long()
    inten = torch.zeros((3, n), dtype=torch.float32)
    trans = torch.ones(n, dtype=torch.float32)
    table = plan.rounds.tolist()
    for r, (first, rays, base, steps) in enumerate(table):
        if not rays:
            continue
        if steps > plan.capacity:
            raise AssertionError(f"{steps} steps in a step list of {plan.capacity}")
        fit, offsets = order[first:first + rays], plan.offsets[first:first + rays] - base
        pos, vel = _replay_march_segments_plain(scene, rec, plan, r)
        if bool(pos.isnan().any()):
            raise AssertionError("the replay's offsets left step-list entries unwritten")
        lengths = torch.diff(offsets, append=offsets.new_tensor([steps]))
        ray = torch.repeat_interleave(torch.arange(rays), lengths)
        key = fit[ray] * (int(lengths.max()) + 1) + torch.arange(steps) - offsets[ray]
        perm = torch.argsort(key)
        emit = torch.empty((steps, 4), dtype=torch.float32)
        emit[perm] = _replay_shade_plain(scene, pos[perm], vel[perm], time)
        inten[:, fit], trans[fit] = _replay_composite_plain(emit, offsets)
    past = torch.cat([order[:table[0][0]], order[table[-1][0] + table[-1][1]:int(plan.counts[0])]])
    if past.numel():
        inten[:, past], trans[past] = _replay_plain(scene, rec, time, past)
    return inten, trans


def media_replay_sorted(scene: SceneConfig, record: Record, time, lib=None,
                        capacity: Optional[int] = None,
                        max_steps: Optional[int] = None) -> Tuple[Vec3, torch.Tensor]:
    """The B pass over the rays that recorded media only, longest first,
    so each warp holds rays of similar replay length. A ray's replay
    depends only on its own records, so this is bitwise the image-layout
    replay. The list is built on the device (`replay_plan`): nothing waits
    for it. `capacity` and `max_steps` as in `media_replay`."""
    n = record.total.numel()
    cap = step_capacity(n, max_steps) if capacity is None else capacity
    plan = replay_plan(record.total, cap, rounds=replay_rounds(n, max_steps, cap), lib=lib)
    return _replay(scene, record.rec, time, with_segments(plan, record.rec, max_steps, lib), lib)


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
    max_steps = settings.resolved_max_steps(scene)
    record = march_pallas_camera_sky_record(
        scene, camera, effects, time, w, h, max_steps,
        *sky.shape, slots=settings.media_slots, device=device, lib=lib, **place,
    )
    if settings.media_sort:
        intensity, trans = media_replay_sorted(scene, record, time, lib=lib, max_steps=max_steps)
    else:
        intensity, trans = media_replay(scene, record.rec, time, lib=lib, max_steps=max_steps)

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
