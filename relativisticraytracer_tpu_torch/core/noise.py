"""Procedural hash/value/cellular noise (port of relativisticraytracer_tpu.core.noise;
reference: include/math_utils.h:65-133).

Exact float32 transcriptions with the JAX package's operation order. The
eight `noise3D` corners are hashed in one stacked pass (a leading axis of
8), which is elementwise and so bitwise the same as eight separate passes,
at an eighth of the operator launches. `fbm` accepts any leading batch
axes the same way.
"""

from __future__ import annotations

import torch

from relativisticraytracer_tpu_torch.core.vecmath import Vec3, length, lerp

_K = 0.1031    # hash multiplier (math_utils.h:66,92)
_C = 33.33     # hash offset (math_utils.h:67-69,93)

# corner order n000, n100, n010, n110, n001, n101, n011, n111
_CORNERS = ((0.0, 0.0, 0.0), (1.0, 0.0, 0.0), (0.0, 1.0, 0.0), (1.0, 1.0, 0.0),
            (0.0, 0.0, 1.0), (1.0, 0.0, 1.0), (0.0, 1.0, 1.0), (1.0, 1.0, 1.0))


def _frac_signed(x):
    """C fmodf(x, 1.0f) = x - trunc(x), bitwise (noise.py:24-29)."""
    return x - torch.trunc(x)


def hash33(p: Vec3) -> Vec3:
    """3->3 hash (reference: math_utils.h:65-71). Component updates are
    sequential: p.x is updated before p.y's dot product reads it."""
    x = _frac_signed(p.x * _K)
    y = _frac_signed(p.y * _K)
    z = _frac_signed(p.z * _K)
    x = x + (x * (y + _C) + y * (z + _C) + z * (x + _C))
    y = y + (x * (x + _C) + y * (z + _C) + z * (y + _C))
    z = z + (x * (x + _C) + y * (y + _C) + z * (z + _C))
    return Vec3(
        _frac_signed((x + y) * z),
        _frac_signed((x + z) * y),
        _frac_signed((y + z) * x),
    )


def hash31(p: Vec3) -> torch.Tensor:
    """3->1 hash (reference: math_utils.h:91-96)."""
    x = _frac_signed(p.x * _K)
    y = _frac_signed(p.y * _K)
    z = _frac_signed(p.z * _K)
    d = x * (y + _C) + y * (z + _C) + z * (x + _C)
    x = x + d
    y = y + d
    z = z + d
    return _frac_signed((x + y) * z)


def _corner_offsets(like: torch.Tensor, axis: int) -> torch.Tensor:
    offs = torch.tensor([c[axis] for c in _CORNERS], dtype=torch.float32,
                        device=like.device)
    return offs.reshape((8,) + (1,) * like.dim())


def noise3D(p: Vec3) -> torch.Tensor:
    """Trilinear value noise with smoothstep fade (reference: math_utils.h:98-110)."""
    ix = torch.floor(p.x)
    iy = torch.floor(p.y)
    iz = torch.floor(p.z)
    fx = p.x - ix
    fy = p.y - iy
    fz = p.z - iz
    ux = fx * fx * (3.0 - 2.0 * fx)
    uy = fy * fy * (3.0 - 2.0 * fy)
    uz = fz * fz * (3.0 - 2.0 * fz)

    n = hash31(Vec3(ix + _corner_offsets(ix, 0), iy + _corner_offsets(iy, 1),
                    iz + _corner_offsets(iz, 2)))
    n000, n100, n010, n110, n001, n101, n011, n111 = n.unbind(0)
    # Lerp order matches the reference exactly (x, then y, then z).
    front = lerp(lerp(n000, n100, ux), lerp(n010, n110, ux), uy)
    back = lerp(lerp(n001, n101, ux), lerp(n011, n111, ux), uy)
    return lerp(front, back, uz)


def fbm(p: Vec3, octaves: int) -> torch.Tensor:
    """N-octave fractal noise, lacunarity 2.05, gain 0.5, +10 domain shift
    per octave (reference: math_utils.h:112-121)."""
    v = torch.zeros_like(p.x)
    a = 0.5
    for _ in range(octaves):
        v = v + a * noise3D(p)
        p = Vec3(p.x * 2.05 + 10.0, p.y * 2.05 + 10.0, p.z * 2.05 + 10.0)
        a *= 0.5
    return v


def fbm_billow(p: Vec3, octaves: int) -> torch.Tensor:
    """Ridge/billow fbm variant (reference: math_utils.h:123-133)."""
    v = torch.zeros_like(p.x)
    a = 0.5
    for _ in range(octaves):
        n = noise3D(p)
        v = v + a * (1.0 - torch.abs(n * 2.0 - 1.0))
        p = Vec3(p.x * 2.05 + 10.0, p.y * 2.05 + 10.0, p.z * 2.05 + 10.0)
        a *= 0.5
    return v


def worley3D(p: Vec3) -> torch.Tensor:
    """Cellular noise over the 3x3x3 neighborhood (reference: math_utils.h:73-89)."""
    ix = torch.floor(p.x)
    iy = torch.floor(p.y)
    iz = torch.floor(p.z)
    f = Vec3(p.x - ix, p.y - iy, p.z - iz)
    min_dist = torch.full_like(p.x, 1.0)
    for z in (-1.0, 0.0, 1.0):
        for y in (-1.0, 0.0, 1.0):
            for x in (-1.0, 0.0, 1.0):
                point = hash33(Vec3(ix + x, iy + y, iz + z))
                diff = Vec3(x + point.x - f.x, y + point.y - f.y, z + point.z - f.z)
                min_dist = torch.minimum(min_dist, length(diff))
    return min_dist
