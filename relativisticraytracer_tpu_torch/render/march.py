"""The geodesic ray march as one masked PyTorch loop (port of
relativisticraytracer_tpu.render.march).

Step semantics match the JAX package (reference: src/raymarcher.cu:41-121):

  1. r from the PRE-step position; horizon capture r < 1.01*Rs
     -> transmittance = 0, ray done;
  2. adaptive step size from PRE-step zone flags;
  3. RK4 step updates position AND velocity;
  4. radiative transfer at the PRE-step position with the POST-step
     velocity, front-to-back compositing;
  5. escape when r > 250 moving outward.

Finished rays are frozen by stepping with h = 0 (p + 0 == p bitwise) and
are dropped from the working set every `chunk` steps; rays are
independent, so that is exact. The media blocks run only on the rays
whose skip probe is True: a False probe contributes exactly zero
(densities.disk_probe_bounds / cloud_probe_bounds), so this is exact too.
This is the plain version every march kernel is held against.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from relativisticraytracer_tpu_torch.config import SceneConfig
from relativisticraytracer_tpu_torch.core.vecmath import Vec3, fdiv, normalize
from relativisticraytracer_tpu_torch.media import densities as densities_mod
from relativisticraytracer_tpu_torch.media.densities import (
    accretion_envelope,
    accretion_streaks,
    disk_temperature,
    dust_base,
    dust_strands,
)
from relativisticraytracer_tpu_torch.physics.geodesics import redshift_factor
from relativisticraytracer_tpu_torch.physics.integrators import _recenter, rk4_step

# Steps between working-set compactions of the plain loops.
CHUNK = 16


class MarchState(NamedTuple):
    p: Vec3                  # position (world)
    v: Vec3                  # coordinate velocity (unit at launch)
    intensity: Vec3          # accumulated RGB emission
    transmittance: torch.Tensor
    hit_horizon: torch.Tensor  # bool
    active: torch.Tensor       # bool

    def index(self, sel) -> "MarchState":
        """The state of the rays selected by `sel` (index or mask)."""
        return MarchState(self.p.map(lambda a: a[sel]), self.v.map(lambda a: a[sel]),
                          self.intensity.map(lambda a: a[sel]),
                          self.transmittance[sel], self.hit_horizon[sel],
                          self.active[sel])


def init_state(origin: Vec3, direction: Vec3) -> MarchState:
    zeros = torch.zeros_like(origin.x)
    return MarchState(
        p=origin,
        v=direction,
        intensity=Vec3(zeros, zeros.clone(), zeros.clone()),
        transmittance=torch.ones_like(zeros),
        hit_horizon=torch.zeros_like(zeros, dtype=torch.bool),
        active=torch.ones_like(zeros, dtype=torch.bool),
    )


def media_probes(scene: SceneConfig, rel: Vec3, in_disk_zone, in_cloud_zone,
                 active):
    """~10-op per-ray masks that are False wherever the media provably
    cannot pass the 0.001 emission gate. None for a disabled medium."""
    r_cyl2 = rel.x * rel.x + rel.z * rel.z
    y2 = rel.y * rel.y
    y4 = y2 * y2
    probe_disk = probe_cloud = None
    if scene.enable_disk:
        k2, rlo2, rhi2 = densities_mod.disk_probe_bounds(scene)
        probe_disk = (active & in_disk_zone & (y4 * r_cyl2 < k2)
                      & (r_cyl2 >= rlo2) & (r_cyl2 <= rhi2))
    if scene.enable_clouds:
        k2, rlo2, rhi2 = densities_mod.cloud_probe_bounds(scene)
        probe_cloud = (active & in_cloud_zone & ((y4 * y4 * y2) * r_cyl2 < k2)
                       & (r_cyl2 >= rlo2) & (r_cyl2 <= rhi2))
    return probe_disk, probe_cloud


def _disk_block(scene: SceneConfig, rel: Vec3, r2, v_new: Vec3, in_disk_zone, time):
    """Disk emission/opacity terms of one step (raymarcher.cu:76-88)."""
    envelope, in_annulus, r_cyl, safe_r = accretion_envelope(scene, rel)
    disk_gate = torch.logical_and(in_disk_zone, in_annulus)
    d_disk = torch.where(
        disk_gate, envelope * accretion_streaks(scene, rel, r_cyl, safe_r, time), 0.0
    )
    lit = d_disk > 0.001
    g = redshift_factor(scene, rel, v_new)  # post-step velocity (cu:77)
    temp = disk_temperature(scene, torch.sqrt(r2))
    t_ratio = fdiv(temp, scene.disk_temp_ref)
    t_norm = torch.sqrt(t_ratio)
    g2 = g * g
    bol_i = (g2 * g2) * t_norm * d_disk * scene.disk_luminosity
    color_t = g * t_ratio ** 0.4 * 2.5
    return (
        torch.where(lit, 1.0 * bol_i, 0.0),
        torch.where(lit, torch.clamp(0.12 * color_t, max=0.25) * bol_i, 0.0),
        torch.where(lit, torch.clamp(0.01 * (color_t - 2.0), min=0.0) * bol_i, 0.0),
        torch.where(lit, d_disk * scene.disk_opacity, 0.0),
    )


def _cloud_block(scene: SceneConfig, rel: Vec3, r2, v_new: Vec3, in_cloud_zone, time):
    """Dust-cloud emission/opacity terms of one step (raymarcher.cu:91-105)."""
    base, in_annulus_c, alive, r_cyl_c, safe_r_c = dust_base(scene, rel)
    cloud_gate = in_cloud_zone & in_annulus_c & alive
    d_cloud = torch.where(
        cloud_gate, base * dust_strands(scene, rel, r_cyl_c, safe_r_c, time), 0.0
    )
    lit = d_cloud > 0.001
    g = redshift_factor(scene, rel, v_new)  # recomputed, as in cu:92
    lighting = 0.5 + 3.0 * (
        fdiv(scene.isco_radius, torch.clamp(torch.sqrt(r2), min=scene.isco_radius))
    ) ** 1.2
    cloud_i = d_cloud * scene.cloud_luminosity * lighting
    t = torch.clamp(fdiv(g - 0.7, 1.3 - 0.7), 0.0, 1.0)
    shift = t * t * (3.0 - 2.0 * t)
    return (
        torch.where(lit, 0.60 * cloud_i * (1.2 + shift * (0.8 - 1.2)), 0.0),
        torch.where(lit, 0.65 * cloud_i * (0.8 + shift * (1.1 - 0.8)), 0.0),
        torch.where(lit, 0.80 * cloud_i * (0.6 + shift * (1.4 - 0.6)), 0.0),
        torch.where(lit, d_cloud * scene.cloud_opacity, 0.0),
    )


def _accumulate(acc, block, sel, *args):
    """acc += block(*args) on the rays `sel` (None = every ray)."""
    if sel is None:
        terms = block(*args)
        return [a + t for a, t in zip(acc, terms)]
    idx = torch.nonzero(sel).squeeze(1)
    if idx.numel() == 0:
        return acc
    sub = [a.map(lambda c: c[idx]) if isinstance(a, Vec3) else
           (a[idx] if isinstance(a, torch.Tensor) and a.dim() else a)
           for a in args]
    terms = block(*sub)
    out = []
    for a, t in zip(acc, terms):
        a = a.clone()
        a[idx] = a[idx] + t
        out.append(a)
    return out


def _media_contribution(scene: SceneConfig, rel: Vec3, r2, v_new: Vec3,
                        in_disk_zone, in_cloud_zone, time,
                        probe_disk=None, probe_cloud=None):
    """Per-step emission/opacity (raymarcher.cu:67-105). `rel`/`r2` are the
    PRE-step position; `v_new` the POST-step velocity. Given probes, each
    medium's block runs only on the rays whose probe is True (exact)."""
    zero = torch.zeros_like(r2)
    acc = [zero, zero, zero, zero]
    if scene.enable_disk:
        acc = _accumulate(acc, _disk_block, probe_disk,
                          scene, rel, r2, v_new, in_disk_zone, time)
    if scene.enable_clouds:
        acc = _accumulate(acc, _cloud_block, probe_cloud,
                          scene, rel, r2, v_new, in_cloud_zone, time)
    emit_r, emit_g, emit_b, opacity = acc
    return Vec3(emit_r, emit_g, emit_b), opacity


def compose_step(intensity: Vec3, trans, ex, ey, ez, opacity, in_media, h):
    """Front-to-back emission/absorption compositing for one step
    (raymarcher.cu:107-115), shared by the march and the replay pass."""
    d_tau = opacity * h
    step_trans = torch.exp(-d_tau)
    factor = (1.0 - step_trans) * trans
    intensity = Vec3(
        intensity.x + torch.where(in_media, ex * factor, 0.0),
        intensity.y + torch.where(in_media, ey * factor, 0.0),
        intensity.z + torch.where(in_media, ez * factor, 0.0),
    )
    trans = torch.where(in_media, trans * step_trans, trans)
    return intensity, trans


def adaptive_h(scene: SceneConfig, r2, in_disk_zone, in_cloud_zone, active):
    """The reference's adaptive step size from PRE-step zone flags
    (raymarcher.cu:54-62), finished rays frozen via h = 0. The product
    step_size * 0.1 etc. is a float32 product, as in the JAX package."""
    near_bh = r2 < 18.0 ** 2
    mult = torch.where(
        near_bh, 0.1,
        torch.where(in_disk_zone, 0.3, torch.where(in_cloud_zone, 0.5, 1.0)),
    )
    h = scene.step_size_m * mult
    return torch.where(active, h, 0.0)


def media_zones(scene: SceneConfig, rel: Vec3, r2):
    """PRE-step zone flags (raymarcher.cu:54-62)."""
    abs_y = torch.abs(rel.y)
    in_disk_zone = (abs_y < scene.disk_h_m * 5.0) & (r2 < (scene.disk_out_m + 5.0) ** 2)
    in_cloud_zone = (abs_y < scene.cloud_h_m * 1.5) & (r2 < scene.cloud_out_m ** 2)
    return in_disk_zone, in_cloud_zone


def march_step(scene: SceneConfig, state: MarchState, time,
               media_hook=None) -> MarchState:
    """One reference march iteration (raymarcher.cu:41-121), fully masked.

    `media_hook` replaces the shading block (the segment recorder of
    ops/pallas_compact.py): it sees the PRE-step position/velocity and
    everything the probes need and returns (intensity, trans)."""
    p, v, intensity, trans, hit, active = state
    eh = scene.event_horizon

    rel = _recenter(scene, p)
    r2 = rel.x * rel.x + rel.y * rel.y + rel.z * rel.z

    # 1. horizon capture, before stepping (captured rays keep their
    # pre-step velocity)
    hit_now = active & (r2 < (eh * 1.01) ** 2)
    hit = hit | hit_now
    trans = torch.where(hit_now, 0.0, trans)
    active = active & ~hit_now

    # 2. adaptive step size from PRE-step zone flags
    in_disk_zone, in_cloud_zone = media_zones(scene, rel, r2)
    h = adaptive_h(scene, r2, in_disk_zone, in_cloud_zone, active)

    # 3. RK4
    p_pre, v_pre = p, v
    p, v = rk4_step(scene, p, v, h)

    # 4. radiative transfer: PRE-step position, POST-step velocity
    if media_hook is not None:
        intensity, trans = media_hook(
            p_pre=p_pre, v_pre=v_pre, rel=rel, r2=r2, v_new=v,
            in_disk_zone=in_disk_zone, in_cloud_zone=in_cloud_zone,
            h=h, active=active, intensity=intensity, trans=trans,
        )
    elif scene.enable_disk or scene.enable_clouds:
        in_media = active & (in_disk_zone | in_cloud_zone)
        probe_disk, probe_cloud = media_probes(scene, rel, in_disk_zone,
                                               in_cloud_zone, active)
        emit, opacity = _media_contribution(
            scene, rel, r2, v, in_disk_zone, in_cloud_zone, time,
            probe_disk=probe_disk, probe_cloud=probe_cloud,
        )
        intensity, trans = compose_step(intensity, trans, emit.x, emit.y,
                                        emit.z, opacity, in_media, h)

    # 5. escape to infinity: POST-step velocity, PRE-step position
    outward = rel.x * v.x + rel.y * v.y + rel.z * v.z > 0.0
    escaped = active & (r2 > scene.escape_radius ** 2) & outward
    active = active & ~escaped

    return MarchState(p, v, intensity, trans, hit, active)


def _scatter(full: MarchState, ids, part: MarchState) -> None:
    """full[ids] = part, field by field (in place)."""
    for dst, src in zip(list(full.p) + list(full.v) + list(full.intensity)
                        + [full.transmittance, full.hit_horizon, full.active],
                        list(part.p) + list(part.v) + list(part.intensity)
                        + [part.transmittance, part.hit_horizon, part.active]):
        dst[ids] = src


def march(
    scene: SceneConfig,
    origin: Vec3,
    direction: Vec3,
    time,
    max_steps: Optional[int] = None,
    chunk: int = CHUNK,
) -> MarchState:
    """March every ray to termination or the step cap. Returns the final
    state with the input's shape."""
    max_steps = scene.max_steps if max_steps is None else max_steps
    shape = origin.x.shape
    flat = lambda a: a.reshape(-1).clone()  # noqa: E731
    full = init_state(origin.map(flat), direction.map(flat))
    ids = torch.arange(full.active.numel(), device=full.active.device)
    st = full.index(ids)  # the working set: a copy, never aliasing `full`
    i = 0
    while i < max_steps and ids.numel():
        for _ in range(min(chunk, max_steps - i)):
            st = march_step(scene, st, time)
        i += min(chunk, max_steps - i)
        _scatter(full, ids, st)
        keep = torch.nonzero(st.active).squeeze(1)
        ids, st = ids[keep], st.index(keep)

    def unflat(a):
        return a.reshape(shape)

    return MarchState(full.p.map(unflat), full.v.map(unflat),
                      full.intensity.map(unflat), unflat(full.transmittance),
                      unflat(full.hit_horizon), unflat(full.active))


def render_hdr(
    scene: SceneConfig,
    origin: Vec3,
    direction: Vec3,
    time,
    sky_fn,
    max_steps: Optional[int] = None,
) -> Tuple[Vec3, MarchState]:
    """March + background compositing (raymarcher.cu:123-150).
    `sky_fn(d: Vec3) -> Vec3` samples the background for the final ray
    direction (black where the horizon was hit)."""
    state = march(scene, origin, direction, time, max_steps)
    bg = sky_fn(normalize(state.v))
    hit = state.hit_horizon
    bg = Vec3(*(torch.where(hit, 0.0, c) for c in bg))
    hdr = Vec3(
        state.intensity.x + bg.x * state.transmittance,
        state.intensity.y + bg.y * state.transmittance,
        state.intensity.z + bg.z * state.transmittance,
    )
    return hdr, state
