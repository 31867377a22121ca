"""Geodesic ODE integrators (port of relativisticraytracer_tpu.physics.integrators;
reference: include/integrators.h). Stage structure, mass re-centering and
combination order match the JAX package exactly; `h` may be per ray."""

from __future__ import annotations

from typing import Tuple

from relativisticraytracer_tpu_torch.config import SceneConfig
from relativisticraytracer_tpu_torch.core.vecmath import Vec3, fdiv
from relativisticraytracer_tpu_torch.physics.geodesics import geodesic_acc


def _recenter(scene: SceneConfig, p: Vec3) -> Vec3:
    """p - MASS_POS; folded out for the (0,0,0) default (x - 0 == x)."""
    mp = scene.mass_pos
    if mp == (0.0, 0.0, 0.0):
        return p
    return Vec3(p.x - mp[0], p.y - mp[1], p.z - mp[2])


def euler_step(scene: SceneConfig, p: Vec3, v: Vec3, h) -> Tuple[Vec3, Vec3]:
    """1st-order Euler (reference: integrators.h:12-18; unused by the kernel)."""
    acc = geodesic_acc(scene, _recenter(scene, p), v)
    return p + v * h, v + acc * h


def rk4_step(scene: SceneConfig, p: Vec3, v: Vec3, h) -> Tuple[Vec3, Vec3]:
    """Classic RK4 on the coupled (position, velocity) ODE
    (reference: integrators.h:23-59)."""
    p0, v0 = p, v

    kv1 = geodesic_acc(scene, _recenter(scene, p0), v0)
    kp1 = v0

    h_half = h * 0.5
    v2 = v0 + kv1 * h_half
    kv2 = geodesic_acc(scene, _recenter(scene, p0 + kp1 * h_half), v2)
    kp2 = v2

    v3 = v0 + kv2 * h_half
    kv3 = geodesic_acc(scene, _recenter(scene, p0 + kp2 * h_half), v3)
    kp3 = v3

    v4 = v0 + kv3 * h
    kv4 = geodesic_acc(scene, _recenter(scene, p0 + kp3 * h), v4)
    kp4 = v4

    # k1 + 2 k2 + 2 k3 + k4, scaled by h/6 (order of integrators.h:54-58).
    kv_sum = kv1 + (kv2 * 2.0 + (kv3 * 2.0 + kv4))
    kp_sum = kp1 + (kp2 * 2.0 + (kp3 * 2.0 + kp4))
    h6 = fdiv(h, 6.0)
    return p + kp_sum * h6, v + kv_sum * h6
