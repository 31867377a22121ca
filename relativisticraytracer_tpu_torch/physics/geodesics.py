"""Pseudo-Kerr photon dynamics (port of relativisticraytracer_tpu.physics.geodesics;
reference: include/geodesics.h).

    a = -1.5 * Rs * |p x v|^2 / r^5 * p          (geodesics.h:35-38)
    a += (2 * a_spin * Rs / r^3) * (axis x p)    (geodesics.h:40-42)

with a hard zero inside r < Rs/2. Guards are `torch.where` selects with
safe denominators. Python-float subexpressions fold in double exactly as
they do in the JAX package (e.g. `-1.5 * eh` is one constant).
"""

from __future__ import annotations

import torch

from relativisticraytracer_tpu_torch.config import SceneConfig
from relativisticraytracer_tpu_torch.core.vecmath import Vec3, dot, fdiv, normalize

_TINY = 1e-12


def geodesic_acc(scene: SceneConfig, p_rel: Vec3, v: Vec3) -> Vec3:
    """Photon acceleration at BH-relative position `p_rel` with coordinate
    velocity `v` (reference: geodesics.h:30-45). Zero inside r < Rs/2."""
    eh = scene.event_horizon
    r2 = dot(p_rel, p_rel)
    inside = r2 < (eh * 0.5) * (eh * 0.5)

    lx = p_rel.y * v.z - p_rel.z * v.y
    ly = p_rel.z * v.x - p_rel.x * v.z
    lz = p_rel.x * v.y - p_rel.y * v.x
    l2 = lx * lx + ly * ly + lz * lz
    inv_r = torch.rsqrt(torch.clamp(r2, min=_TINY))
    inv_r2 = inv_r * inv_r
    inv_r5 = inv_r2 * inv_r2 * inv_r
    radial_mag = -1.5 * eh * l2 * inv_r5
    radial_mag = torch.where(inside, 0.0, radial_mag)
    ax = p_rel.x * radial_mag
    ay = p_rel.y * radial_mag
    az = p_rel.z * radial_mag

    if scene.spin_a != 0.0:
        # Frame dragging: (2 a Rs / r^3) * (axis x p)  (geodesics.h:40-42).
        sx, sy, sz = scene.spin_axis
        dx = sy * p_rel.z - sz * p_rel.y
        dy = sz * p_rel.x - sx * p_rel.z
        dz = sx * p_rel.y - sy * p_rel.x
        strength = (2.0 * scene.spin_a * eh) * (inv_r2 * inv_r)
        strength = torch.where(inside, 0.0, strength)
        ax = ax + dx * strength
        ay = ay + dy * strength
        az = az + dz * strength

    return Vec3(ax, ay, az)


def redshift_factor(scene: SceneConfig, p_rel: Vec3, ray_vel: Vec3) -> torch.Tensor:
    """Gravitational-redshift x Doppler-beaming factor g
    (reference: geodesics.h:11-25). Zero inside r < 1.01*Rs."""
    eh = scene.event_horizon
    r = torch.sqrt(dot(p_rel, p_rel))
    dead = r < eh * 1.01

    r_safe = torch.clamp(r, min=eh * 1.005)
    g_gravity = torch.sqrt(1.0 - fdiv(eh, r_safe))

    v_mag = 1.0 / (r_safe * torch.sqrt(r_safe) + scene.spin_a)  # r^1.5
    gas_dir = normalize(Vec3(-p_rel.z, torch.zeros_like(r), p_rel.x))
    cos_theta = dot(ray_vel, gas_dir)

    gamma = 1.0 / torch.sqrt(1.0 - v_mag * v_mag)
    g_doppler = 1.0 / (gamma * (1.0 - v_mag * cos_theta))

    return torch.where(dead, 0.0, g_gravity * g_doppler)
