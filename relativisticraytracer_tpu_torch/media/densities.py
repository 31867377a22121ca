"""Procedural volumetric media (port of relativisticraytracer_tpu.media.densities;
reference: include/densities.h).

Branch-free transcriptions with the JAX package's operation order: every
early `return 0` is a `torch.where` on the same predicate. The skip-probe
bounds are host Python floats computed by the same formulas as the JAX
package, so they are equal to its floats.
"""

from __future__ import annotations

import math

import torch

from relativisticraytracer_tpu_torch.config import SceneConfig
from relativisticraytracer_tpu_torch.core.fastmath import atan2
from relativisticraytracer_tpu_torch.core.noise import fbm, noise3D
from relativisticraytracer_tpu_torch.core.vecmath import Vec3, fdiv, smoothstep

_R_EPS = 1e-6

# Upper bound of the disk streak factor (0.02 + 5*cloud, cloud clamped to 6).
DISK_STREAK_MAX = 30.02

# Root of 3t^2 - 2t^3 = 0.001, rounded up (see the JAX package).
_SMOOTHSTEP_T1 = 0.018377


def disk_temperature(scene: SceneConfig, r: torch.Tensor) -> torch.Tensor:
    """Shakura-Sunyaev T(r) = T_ref * (r/ISCO)^-0.75, zero inside the ISCO
    (reference: densities.h:12-15)."""
    safe_r = torch.clamp(r, min=_R_EPS)
    t = scene.disk_temp_ref * fdiv(safe_r, scene.isco_radius) ** -0.75
    return torch.where(r < scene.isco_radius, 0.0, t)


def disk_probe_bounds(scene: SceneConfig):
    """Cheap per-step skip probe for the disk (static Python floats).
    Returns (k2, r_lo2, r_hi2): the disk can pass its 0.001 emission gate
    only where y^4 * r_cyl^2 < k2 and r_lo2 <= r_cyl^2 <= r_hi2. Skipping on
    this probe is exact: False => the step contributes nothing."""
    big_l = math.log(DISK_STREAK_MAX / 0.001)
    t0 = math.sqrt(0.001 / DISK_STREAK_MAX)
    r_hi = scene.disk_out_m * (1.0 - 0.15 * t0 * 0.999)
    k = (2.0 * scene.disk_h_m ** 2 * scene.isco_radius * big_l
         + 1e-7 * big_l * r_hi) * 1.0001
    k2 = k * k
    r_lo2 = (scene.isco_radius * 0.99999) ** 2
    r_hi2 = (r_hi * 1.00001) ** 2
    return k2, r_lo2, r_hi2


def cloud_probe_bounds(scene: SceneConfig):
    """Same idea for the clouds: (k2, r_lo2, r_hi2) with the pow-free probe
    y^10 * r_cyl^2 < k2 and r_lo2 <= r_cyl^2 <= r_hi2."""
    big_l = math.log(1000.0)
    r_hi = scene.disk_out_m * (1.0 - 0.2 * _SMOOTHSTEP_T1 * 0.999)
    c = (0.5 * scene.cloud_h_m ** 2 * scene.isco_radius ** 0.4 * big_l
         + 1e-7 * big_l * r_hi ** 0.4) * 1.0001
    k2 = c ** 5
    r_lo = scene.isco_radius + 5.0 * _SMOOTHSTEP_T1 * 0.999
    r_lo2 = (r_lo * 0.99999) ** 2
    r_hi2 = (r_hi * 1.00001) ** 2
    return k2, r_lo2, r_hi2


def accretion_envelope(scene: SceneConfig, p: Vec3):
    """Stage 1 of the disk density (densities.h:25-35).
    Returns (envelope, in_annulus, r_cyl, safe_r)."""
    isco = scene.isco_radius
    disk_out = scene.disk_out_m

    r = torch.sqrt(p.x * p.x + p.z * p.z)
    in_annulus = torch.logical_and(r >= isco, r <= disk_out)
    safe_r = torch.clamp(r, min=_R_EPS)

    edge_start = disk_out * 0.85
    ef = 1.0 - fdiv(r - edge_start, disk_out - edge_start)
    edge_falloff = torch.where(r > edge_start, ef * ef, 1.0)

    local_h = scene.disk_h_m * torch.sqrt(fdiv(isco, safe_r))
    vertical_density = torch.exp(-(p.y * p.y) / (2.0 * local_h * local_h + 1e-7))
    radial_density = fdiv(isco, safe_r) ** 0.4
    return vertical_density * radial_density * edge_falloff, in_annulus, r, safe_r


def accretion_streaks(scene: SceneConfig, p: Vec3, r, safe_r, time) -> torch.Tensor:
    """Stage 2: the rotating 5-octave fbm streak factor (densities.h:38-59)."""
    isco = scene.isco_radius
    phi = atan2(p.z, p.x)
    t_r = fdiv(isco, safe_r)
    omega = 3.5 * (t_r * torch.sqrt(t_r))
    angle_rotated = phi - time * omega

    rot = Vec3(r * torch.cos(angle_rotated), p.y * 4.0, r * torch.sin(angle_rotated))
    evolution = time * 0.35
    noise_coords = Vec3(rot.x * 0.45, rot.y * 0.45 + evolution, rot.z * 0.45)
    n = fbm(noise_coords, scene.octaves(5))

    cloud = torch.clamp(n - 0.32, min=0.0)
    cloud = (cloud * 2.8) ** 1.6
    cloud = torch.clamp(cloud, max=6.0)
    return 0.02 + 5.0 * cloud


def accretion_density(scene: SceneConfig, p: Vec3, time) -> torch.Tensor:
    """Accretion-disk gas density (reference: densities.h:20-62)."""
    envelope, in_annulus, r, safe_r = accretion_envelope(scene, p)
    out = envelope * accretion_streaks(scene, p, r, safe_r, time)
    return torch.where(in_annulus, out, 0.0)


def dust_base(scene: SceneConfig, p: Vec3):
    """Stage 1 of the cloud density (densities.h:74-85).
    Returns (base, in_annulus, alive, r, safe_r)."""
    isco = scene.isco_radius
    disk_out = scene.disk_out_m  # NB: the reference gates clouds on DISK_OUT_M too

    r = torch.sqrt(p.x * p.x + p.z * p.z)
    in_annulus = torch.logical_and(r >= isco, r <= disk_out)
    safe_r = torch.clamp(r, min=_R_EPS)

    edge_falloff = smoothstep(disk_out, disk_out * 0.8, r)
    inner_taper = smoothstep(isco, isco + 5.0, r)
    local_h = scene.cloud_h_m * 0.5 * fdiv(isco, safe_r) ** 0.2
    vertical_profile = torch.exp(-(p.y * p.y) / (2.0 * local_h * local_h + 1e-7))
    base = vertical_profile * edge_falloff * inner_taper
    alive = base >= 0.001
    return base, in_annulus, alive, r, safe_r


def _stack3(a, b, c) -> torch.Tensor:
    return torch.stack([a, b, c])


def dust_strands(scene: SceneConfig, p: Vec3, r, safe_r, time) -> torch.Tensor:
    """Stage 2: the warped multi-octave wisp factor (densities.h:88-128),
    including the final x12 gain. The three warp fbms of each stage run as
    one stacked pass (elementwise, so bitwise the separate passes)."""
    isco = scene.isco_radius

    phi = atan2(p.z, p.x)
    t_r = fdiv(isco, safe_r)
    omega = t_r * torch.sqrt(t_r)
    angle_rot = phi - time * omega

    coords = Vec3(r * 0.8, p.y * 15.0, angle_rot * 10.0)
    c15 = Vec3(coords.x * 0.15, coords.y * 0.15, coords.z * 0.15)
    w_oct = scene.octaves(2)
    w1 = fbm(Vec3(_stack3(c15.x, c15.x + 1.0, c15.x + 4.0),
                  _stack3(c15.y, c15.y + 2.0, c15.y + 5.0),
                  _stack3(c15.z, c15.z + 3.0, c15.z + 6.0)), w_oct)
    w2c = Vec3(coords.x + w1[0] * 3.0, coords.y + w1[1] * 3.0, coords.z + w1[2] * 3.0)
    w2c4 = Vec3(w2c.x * 0.4, w2c.y * 0.4, w2c.z * 0.4)
    w2 = fbm(Vec3(_stack3(w2c4.x, w2c4.x + 2.0, w2c4.x + 0.0),
                  _stack3(w2c4.y, w2c4.y + 1.0, w2c4.y + 3.0),
                  _stack3(w2c4.z, w2c4.z + 0.0, w2c4.z + 1.0)), w_oct)
    fc = Vec3(coords.x + w2[0] * 1.5, coords.y + w2[1] * 1.5, coords.z + w2[2] * 1.5)

    n = torch.zeros_like(r)
    amp = 1.0
    freq = 1.0
    for _ in range(scene.octaves(5)):
        noise_val = noise3D(Vec3(fc.x * freq, fc.y * freq, fc.z * freq))
        wisp = 1.0 - torch.abs(noise_val * 2.0 - 1.0)
        n = n + wisp * amp
        amp *= 0.5
        freq *= 2.1

    strands = smoothstep(0.4, 0.8, n * 0.55)
    s2 = strands * strands
    strands = s2 * s2  # x^4
    detail = fbm(Vec3(fc.x * 4.0, fc.y * 4.0 + time * 0.5, fc.z * 4.0), scene.octaves(2))
    strands = strands * (0.6 + 0.4 * detail)
    return strands * 12.0


def dust_cloud_density(scene: SceneConfig, p: Vec3, time) -> torch.Tensor:
    """Large-scale dust-cloud density (reference: densities.h:69-132)."""
    base, in_annulus, alive, r, safe_r = dust_base(scene, p)
    out = base * dust_strands(scene, p, r, safe_r, time)
    return torch.where(torch.logical_and(in_annulus, alive), out, 0.0)
