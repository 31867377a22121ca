"""Equirectangular skybox sampling (port of relativisticraytracer_tpu.render.skybox).

The texture is stored quad-packed, as in the JAX package: per channel one
32-bit plane whose entry at (y0+1, x0) holds the 2x2 bilinear footprint
c(x0,ya) | c(x1,ya)<<8 | c(x0,yb)<<16 | c(x1,yb)<<24 with U-wrap and V-clamp
baked in. PyTorch on the CPU has no shifts for uint32, so the port keeps
the planes as int32 with identical bits and masks after arithmetic shifts;
the CUDA kernel reads the same bits as uint32. Filtering is done in
float32 with the JAX package's exact operation order (never hardware
texture filtering, whose weights are fixed-point).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from relativisticraytracer_tpu_torch.config import PI
from relativisticraytracer_tpu_torch.core.fastmath import arcsin as _arcsin
from relativisticraytracer_tpu_torch.core.fastmath import atan2 as _atan2
from relativisticraytracer_tpu_torch.core.noise import fbm, hash31
from relativisticraytracer_tpu_torch.core.vecmath import Vec3, fdiv


class Skybox(NamedTuple):
    """Device-resident quad-packed equirect texture: per channel an int32
    [H+1, W] plane (see the module docstring). `q4` is the channel-
    interleaved copy [(H+1)*W, 4] = (qr, qg, qb, 0) rows, so one 16-byte
    load fetches a pixel's whole 96-bit footprint when chromatic
    aberration is off."""

    qr: torch.Tensor
    qg: torch.Tensor
    qb: torch.Tensor
    q4: Optional[torch.Tensor] = None

    @property
    def shape(self):
        """Logical texture (H, W)."""
        hq, w = self.qr.shape
        return (hq - 1, w)

    def to(self, device) -> "Skybox":
        return Skybox(*(None if t is None else t.to(device) for t in self))


def _quad_pack(plane: np.ndarray) -> np.ndarray:
    """uint8 [H, W] channel -> uint32 [H+1, W] quad plane (see Skybox)."""
    h, w = plane.shape
    p = plane.astype(np.uint32)
    right = np.roll(p, -1, axis=1)                      # x1 = (x0+1) mod W
    ya = np.clip(np.arange(-1, h), 0, h - 1)            # top row, clamped
    yb = np.clip(np.arange(0, h + 1), 0, h - 1)         # bottom row, clamped
    return p[ya] | (right[ya] << 8) | (p[yb] << 16) | (right[yb] << 24)


def skybox_from_array(rgba: np.ndarray, device) -> Skybox:
    """uint8 [H, W, 3or4] host image -> Skybox resident on `device`, with
    its interleaved q4 table (the one-time upload, analog of
    cudaMemcpy2DToArray at main.cpp:247-248)."""
    rgba = np.asarray(rgba)
    if rgba.dtype != np.uint8:
        raise ValueError(f"skybox must be uint8, got {rgba.dtype}")
    planes = [_quad_pack(rgba[..., c]) for c in range(3)]
    q4 = np.stack([p.reshape(-1) for p in planes]
                  + [np.zeros(planes[0].size, np.uint32)], axis=-1)
    return Skybox(*(torch.from_numpy(a.view(np.int32)).to(device)
                    for a in planes + [q4]))


def sky_coords_from_uv(h: int, w: int, tx: torch.Tensor, ty: torch.Tensor):
    """CUDA tex2D addressing (main.cpp:255-261) -> (flat quad index int32,
    fx, fy): wrap-U, clamp-V, the sample at (u*W - 0.5, v*H - 0.5)."""
    ux = (tx - torch.floor(tx)) * float(w)
    vy = torch.clamp(ty, 0.0, 1.0) * float(h)

    xb = ux - 0.5
    yb = vy - 0.5
    x0 = torch.floor(xb)
    y0 = torch.floor(yb)
    fx = xb - x0
    fy = yb - y0

    # ux in [0, W] => x0 in [-1, W-1]: one add-if-negative IS the mod.
    x0i = x0.to(torch.int32)
    x0i = torch.where(x0i < 0, x0i + w, x0i)
    # vy in [0, H] => y0 in [-1, H-1]; quad planes are indexed by y0+1.
    yq = y0.to(torch.int32) + 1
    return yq * w + x0i, fx, fy


def corner_bilinear(c00, c10, c01, c11, fx, fy) -> torch.Tensor:
    """Bilinear-filter four unpacked texel corners (f32 values 0..255) with
    fractional weights (fx, fy); normalized-float read (uint8/255)."""
    top = c00 + fx * (c10 - c00)
    bot = c01 + fx * (c11 - c01)
    return (top + fy * (bot - top)) * (1.0 / 255.0)


def quad_bilinear(t: torch.Tensor, fx: torch.Tensor, fy: torch.Tensor) -> torch.Tensor:
    """Unpack one gathered int32 quad (see Skybox) and bilinear-filter it."""
    c00 = (t & 0xFF).to(torch.float32)
    c10 = ((t >> 8) & 0xFF).to(torch.float32)
    c01 = ((t >> 16) & 0xFF).to(torch.float32)
    c11 = ((t >> 24) & 0xFF).to(torch.float32)
    return corner_bilinear(c00, c10, c01, c11, fx, fy)


def sky_coords(d: Vec3, ca_offset: float, h: int, w: int):
    """Escape direction -> per-channel gather coordinates
    ((idx_r, fx_r, fy_r), (idx_g, ...), (idx_b, ...)). `ca_offset` is the
    effective chromatic-aberration phi offset (0.0 when the effect is off,
    so all three sets are the G set, raymarcher.cu:131-145)."""
    phi = _atan2(d.z, d.x)
    theta = _arcsin(d.y)
    ty = 0.5 - fdiv(theta, PI)
    out = []
    for off in (ca_offset, 0.0, -ca_offset):
        tx = 0.5 + fdiv(phi + off, 2.0 * PI)
        out.append(sky_coords_from_uv(h, w, tx, ty))
    return tuple(out)


def gather_sky_coords(tex: Skybox, coords, effects) -> Vec3:
    """Background from per-channel (flat quad index, fx, fy) coordinates:
    with chromatic aberration off, one q4 row per pixel at the G index
    (all channels share it); CA on, or no q4 table, per-channel gathers."""
    if effects.use_chromatic_aberration > 0.5 or tex.q4 is None:
        planes = (tex.qr, tex.qg, tex.qb)
        return Vec3(*(
            quad_bilinear(plane.reshape(-1)[idx], fx, fy)
            for plane, (idx, fx, fy) in zip(planes, coords)
        ))
    idx, fx, fy = coords[1]
    t4 = tex.q4[idx]
    return Vec3(*(quad_bilinear(t4[..., c], fx, fy) for c in range(3)))


def sample_sky_fast(tex: Skybox, d: Vec3, effects) -> Vec3:
    """Background color for escape direction d, chromatic aberration as
    +/- phi offsets on R/B (raymarcher.cu:131-145). Bitwise the JAX
    package's `sample_sky` (same uv math)."""
    h, w = tex.shape
    return gather_sky_coords(tex, sky_coords(d, effects.ca_offset(), h, w), effects)


def procedural_starfield(height: int = 1024, width: int = 2048, seed: float = 7.0,
                         device="cuda") -> np.ndarray:
    """Deterministic procedural equirect starfield + nebula, built from the
    framework's own hash/fbm stack. Returns uint8 [height, width, 4].
    sin/cos differ from XLA's by an ulp here and there, so threshold
    pixels may flip against the JAX package's array."""
    ys = torch.arange(height, dtype=torch.float32, device=device)
    xs = torch.arange(width, dtype=torch.float32, device=device)
    ty = fdiv(ys[:, None] + 0.5, float(height))
    tx = fdiv(xs[None, :] + 0.5, float(width))
    phi = (tx - 0.5) * (2.0 * PI)
    theta = (0.5 - ty) * PI
    d = Vec3(
        torch.cos(theta) * torch.cos(phi),
        torch.sin(theta).expand(height, width),
        torch.cos(theta) * torch.sin(phi),
    )
    cell = Vec3(d.x * 384.0 + seed, d.y * 384.0 - seed, d.z * 384.0 + 2.0 * seed)
    hq = hash31(Vec3(torch.floor(cell.x), torch.floor(cell.y), torch.floor(cell.z)))
    stars = torch.clamp((torch.abs(hq) - 0.9985) * 700.0, 0.0, 1.0)
    neb = fbm(Vec3(d.x * 3.0 + seed, d.y * 3.0, d.z * 3.0 - seed), 4)
    neb = torch.clamp(neb - 0.45, 0.0, 1.0)
    r = torch.clamp(stars + 0.30 * neb, 0.0, 1.0)
    g = torch.clamp(stars + 0.18 * neb, 0.0, 1.0)
    b = torch.clamp(stars + 0.45 * neb, 0.0, 1.0)
    img = torch.stack(
        [r * 255.0, g * 255.0, b * 255.0, torch.full_like(r, 255.0)], dim=-1
    ).to(torch.uint8)
    return img.cpu().numpy()
