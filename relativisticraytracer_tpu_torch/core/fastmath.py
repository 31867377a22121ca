"""Polynomial atan2/arcsin (port of relativisticraytracer_tpu.core.fastmath).

The JAX package evaluates atan2 as a minimax polynomial (max abs error
2.4e-7 in float32) built from mul/add/div/select, and the sky addressing
and the media densities follow it. The port transcribes the same
polynomial, never `torch.atan2`, so sky indices and noise inputs match.
The CUDA kernels carry the same code (csrc/march_common.cuh).

Signed-zero caveat (as in the JAX package): y = -0.0 is treated as
non-negative, so atan2(-0.0, x<0) returns +pi.
"""

from __future__ import annotations

import torch

_PI = 3.14159265358979
_PI_2 = 1.5707963267948966

# atan(t)/t as a degree-8 polynomial in s = t^2, minimax-fit on t in [0, 1].
_ATAN_COEF = (
    0.9999999937528704,
    -0.3333313796574813,
    0.19993694134109075,
    -0.1421110450729569,
    0.10667480453561796,
    -0.07556885545726152,
    0.04327805721553666,
    -0.016413069634952718,
    0.002932729905334909,
)


def _atan_unit(t):
    """atan(t) for t in [0, 1]."""
    s = t * t
    acc = torch.full_like(t, _ATAN_COEF[-1])
    for c in _ATAN_COEF[-2::-1]:
        acc = acc * s + c
    return acc * t


def atan2(y, x):
    """Four-quadrant arctangent (~2 ulp). atan2(0, 0) = 0."""
    ax = torch.abs(x)
    ay = torch.abs(y)
    mx = torch.maximum(ax, ay)
    mn = torch.minimum(ax, ay)
    t = mn / torch.clamp(mx, min=1e-37)      # in [0, 1]; 0 at the origin
    a = _atan_unit(t)
    a = torch.where(ay > ax, _PI_2 - a, a)    # reflect past 45 degrees
    a = torch.where(x < 0.0, _PI - a, a)      # quadrants II/III
    return torch.where(y < 0.0, -a, a)        # sign of y


def arcsin(x):
    """asin via atan2(x, sqrt(1-x^2)); |x| clamped to 1."""
    xc = torch.clamp(x, -1.0, 1.0)
    return atan2(xc, torch.sqrt(torch.clamp(1.0 - xc * xc, min=0.0)))
