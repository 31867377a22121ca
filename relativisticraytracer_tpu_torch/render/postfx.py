"""Post-processing chain (port of relativisticraytracer_tpu.render.postfx;
reference: include/camera_effects/post_processing.h and the kernel
epilogue, src/raymarcher.cu:152-173).

All effects are per-pixel closed forms (the reference "bloom" is a luma
threshold self-add with no blur). Effect parameters are float32-exact
Python floats (config.CameraEffects); products of two of them are taken in
float32 on the host, as the JAX package takes them on float32 arrays.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from relativisticraytracer_tpu_torch.core.vecmath import Vec3, fdiv, smoothstep

# Rec.709 luma weights (post_processing.h:28)
_LUMA_R = 0.2126
_LUMA_G = 0.7152
_LUMA_B = 0.0722


def grain_hash(px, py):
    """Film-grain hash (reference: post_processing.h:9-11; unused by the
    reference kernel, kept for API parity)."""
    d = px * 12.9898 + py * 78.233
    return torch.fmod(torch.sin(d) * 43758.5453, 1.0)


def apply_lens_distortion(uv_x, uv_y, k) -> Tuple[torch.Tensor, torch.Tensor]:
    """Barrel distortion uv' = t*(1 + k*r^2) + 0.5, t = uv - 0.5
    (reference: post_processing.h:19-24). Applied before ray generation."""
    tx = uv_x - 0.5
    ty = uv_y - 0.5
    r2 = tx * tx + ty * ty
    f = 1.0 + r2 * k
    return tx * f + 0.5, ty * f + 0.5


def apply_vignette(color: Vec3, uv_x, uv_y, intensity) -> Vec3:
    """Radial smoothstep(0.8 -> 0.2) multiplier on |uv - 0.5| * intensity
    (reference: post_processing.h:13-17), on the distorted uv."""
    dx = uv_x - 0.5
    dy = uv_y - 0.5
    d = torch.sqrt(dx * dx + dy * dy)
    v = smoothstep(0.8, 0.2, d * intensity)
    return Vec3(color.x * v, color.y * v, color.z * v)


def bloom_contribution(color: Vec3, threshold) -> Vec3:
    """Luma-threshold pass-through — the reference bloom has no blur
    (post_processing.h:27-31)."""
    brightness = color.x * _LUMA_R + color.y * _LUMA_G + color.z * _LUMA_B
    keep = brightness > threshold
    return Vec3(
        torch.where(keep, color.x, 0.0),
        torch.where(keep, color.y, 0.0),
        torch.where(keep, color.z, 0.0),
    )


def tonemap(color: Vec3, exposure) -> Vec3:
    """Exponential tone map 1 - exp(-c * EXPOSURE) (raymarcher.cu:164-166)."""
    return Vec3(
        1.0 - torch.exp(-color.x * exposure),
        1.0 - torch.exp(-color.y * exposure),
        1.0 - torch.exp(-color.z * exposure),
    )


def apply_effects_and_tonemap(hdr: Vec3, uv_x, uv_y, effects, exposure) -> Vec3:
    """Full kernel epilogue (raymarcher.cu:152-166) with 0/1 effect flags."""
    bloom = bloom_contribution(hdr, effects.bloom_threshold)
    gain = float(np.float32(effects.use_bloom) * np.float32(effects.bloom_intensity))
    hdr = Vec3(hdr.x + bloom.x * gain, hdr.y + bloom.y * gain, hdr.z + bloom.z * gain)
    if effects.use_vignette > 0.5:
        hdr = apply_vignette(hdr, uv_x, uv_y, effects.vignette_intensity)
    return tonemap(hdr, exposure)


def _chan8(c: torch.Tensor) -> torch.Tensor:
    # The reference C cast truncates toward zero (raymarcher.cu:168-172);
    # torch's float->integer conversion truncates too.
    return torch.clamp(c * 255.0, 0.0, 255.0).to(torch.uint8)


def pack_rgba8(ldr: Vec3) -> torch.Tensor:
    """float [0,1) -> uint8[H, W, 4], alpha=255, truncating cast."""
    r = _chan8(ldr.x)
    return torch.stack([r, _chan8(ldr.y), _chan8(ldr.z), torch.full_like(r, 255)],
                       dim=-1)


def pack_rgba8_word(ldr: Vec3) -> torch.Tensor:
    """float [0,1) -> one int32 word per pixel, R|G<<8|B<<16|255<<24 (the
    JAX package's uint32 word, same bits; torch has no uint32 shifts)."""
    def chan(c):
        return torch.clamp(c * 255.0, 0.0, 255.0).to(torch.int32)

    return chan(ldr.x) | (chan(ldr.y) << 8) | (chan(ldr.z) << 16) | -(1 << 24)


def word_to_rgba8(word: torch.Tensor) -> torch.Tensor:
    """int32[H, W] packed pixels -> uint8[H, W, 4] RGBA (little-endian bytes)."""
    h, w = word.shape
    return word.contiguous().view(torch.uint8).reshape(h, w, 4)


def downsample_box(ldr: Vec3, s: int) -> Vec3:
    """SSAA resolve: (s*H, s*W) -> (H, W) box filter (post-tonemap).
    s=1 is the identity (reference behavior)."""
    if s == 1:
        return ldr

    def d(c):
        hs, ws = c.shape
        return c.reshape(hs // s, s, ws // s, s).mean(dim=(1, 3))

    return Vec3(d(ldr.x), d(ldr.y), d(ldr.z))


def yuv420_from_rgba8(frame: torch.Tensor) -> torch.Tensor:
    """uint8[H, W, 4] RGBA -> flat uint8[H*W*3//2] planar YUV420 (BT.601
    limited range), on the frame's device: the byte stream FFmpeg expects
    for `-f rawvideo -pix_fmt yuv420p` (Y plane, then 2x2-subsampled U, V).

    The animation transfer format: 1.5 B/px over the device->host link
    instead of 4 (reference encode: main.cpp:60-72, rawvideo rgba in,
    -pix_fmt yuv420p out). The divisions are float32 divisions
    (vecmath.fdiv), the chroma is averaged over its 2x2 box before the +0.5,
    and the uint8 cast truncates, as in the JAX package. H and W must be
    even."""
    h, w, _ = frame.shape
    if h % 2 or w % 2:
        raise ValueError(f"yuv420 needs even dims, got {w}x{h}")
    rgb = frame[..., :3].to(torch.float32) * (1.0 / 255.0)
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    yp = 0.299 * r + 0.587 * g + 0.114 * b
    y8 = torch.clamp(16.0 + 219.0 * yp + 0.5, 0.0, 255.0).to(torch.uint8)
    u = 128.0 + fdiv(112.0 * (b - yp), 0.886)
    v = 128.0 + fdiv(112.0 * (r - yp), 0.701)

    def sub(c):  # 2x2 box average, then quantize
        c = c.reshape(h // 2, 2, w // 2, 2).mean(dim=(1, 3))
        return torch.clamp(c + 0.5, 0.0, 255.0).to(torch.uint8)

    return torch.cat([y8.reshape(-1), sub(u).reshape(-1), sub(v).reshape(-1)])
