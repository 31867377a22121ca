"""Structure-of-arrays 3-vector math (port of relativisticraytracer_tpu.core.vecmath;
reference: include/math_utils.h:11-61).

A `Vec3` is a NamedTuple of three same-shaped float32 tensors (x, y, z
planes), the JAX package's public layout. Every function keeps the JAX
version's guards and operation order — they are the parity bedrock.
"""

from __future__ import annotations

from typing import NamedTuple, Union

import torch

Tensor = torch.Tensor
Scalar = Union[float, Tensor]


class Vec3(NamedTuple):
    x: Tensor
    y: Tensor
    z: Tensor

    def __add__(self, o: "Vec3") -> "Vec3":  # type: ignore[override]
        return Vec3(self.x + o.x, self.y + o.y, self.z + o.z)

    def __sub__(self, o: "Vec3") -> "Vec3":
        return Vec3(self.x - o.x, self.y - o.y, self.z - o.z)

    def __mul__(self, s: Scalar) -> "Vec3":  # type: ignore[override]
        return Vec3(self.x * s, self.y * s, self.z * s)

    __rmul__ = __mul__

    def __neg__(self) -> "Vec3":
        return Vec3(-self.x, -self.y, -self.z)

    def map(self, fn) -> "Vec3":
        """Apply `fn` to each component (indexing, casting, moving)."""
        return Vec3(fn(self.x), fn(self.y), fn(self.z))


def vec3(x, y, z, device=None) -> Vec3:
    return Vec3(*(torch.as_tensor(c, dtype=torch.float32, device=device)
                  for c in (x, y, z)))


def dot(a: Vec3, b: Vec3) -> Tensor:
    """reference: math_utils.h:11-13"""
    return a.x * b.x + a.y * b.y + a.z * b.z


def cross(a: Vec3, b: Vec3) -> Vec3:
    """reference: math_utils.h:15-17"""
    return Vec3(
        a.y * b.z - a.z * b.y,
        a.z * b.x - a.x * b.z,
        a.x * b.y - a.y * b.x,
    )


def length(v: Vec3) -> Tensor:
    """reference: math_utils.h:19-21"""
    return torch.sqrt(v.x * v.x + v.y * v.y + v.z * v.z)


def normalize(v: Vec3) -> Vec3:
    """reference: math_utils.h:23-27 — returns the zero vector when |v| < 1e-6."""
    mag = length(v)
    small = mag < 1e-6
    inv = 1.0 / torch.where(small, 1.0, mag)
    return Vec3(
        torch.where(small, 0.0, v.x * inv),
        torch.where(small, 0.0, v.y * inv),
        torch.where(small, 0.0, v.z * inv),
    )


def fdiv(a: Scalar, b: Scalar) -> Tensor:
    """a / b correctly rounded in float32 on every device, as the JAX
    package divides. A Python float operand becomes a float32 scalar
    tensor on the other operand's device: torch evaluates `float / tensor`
    as reciprocal(tensor) * float, and on CUDA `tensor / float` as
    tensor * (1 / float), each of which rounds twice. The scalar is made
    with a fill on the device: `torch.tensor(x, device=...)` copies from
    pageable host memory, which waits for the device's queue."""
    if not isinstance(a, torch.Tensor):
        a = torch.full((), a, dtype=torch.float32, device=b.device)
    elif not isinstance(b, torch.Tensor):
        b = torch.full((), b, dtype=torch.float32, device=a.device)
    return torch.div(a, b)


def lerp(a: Scalar, b: Scalar, t: Scalar) -> Tensor:
    """reference: math_utils.h:41-43"""
    return a + t * (b - a)


def smoothstep(edge0: float, edge1: float, x: Tensor) -> Tensor:
    """reference: math_utils.h:45-48 (callers sometimes pass edge0 > edge1).
    The edges are Python floats, folded as the JAX package folds them."""
    t = torch.clamp(fdiv(x - edge0, edge1 - edge0), 0.0, 1.0)
    return t * t * (3.0 - 2.0 * t)


def rotate_3d(p: Vec3, axis: Vec3, angle: Scalar) -> Vec3:
    """Axis-angle rotation (reference: math_utils.h:52-61; unused by the
    reference kernel but part of its public math surface)."""
    angle = torch.as_tensor(angle, dtype=torch.float32, device=p.x.device)
    s = torch.sin(angle)
    c = torch.cos(angle)
    oc = 1.0 - c
    ax, ay, az = axis.x, axis.y, axis.z
    return Vec3(
        (oc * ax * ax + c) * p.x + (oc * ax * ay - az * s) * p.y + (oc * az * ax + ay * s) * p.z,
        (oc * ax * ay + az * s) * p.x + (oc * ay * ay + c) * p.y + (oc * ay * az - ax * s) * p.z,
        (oc * az * ax - ay * s) * p.x + (oc * ay * az + ax * s) * p.y + (oc * az * az + c) * p.z,
    )
