"""Sky background of the frame path (port of
relativisticraytracer_tpu.ops.pallas_sky).

The JAX package fetches each escaped ray's packed bilinear quads through
per-sub-tile sky windows (DMA + MXU one-hot gather) with a compacted
row-gather fallback: answers to the TPU's slow gathers. A GPU gathers
straight from L2/HBM, so the port's kernel (csrc/sky.cu) is a per-pixel
gather + `corner_bilinear` filter. The contract is the JAX one
(pallas_sky.py:328-337): unmasked pixels get a background bitwise equal
to `render.skybox.gather_sky_coords`; masked pixels (captured rays,
transmittance exactly 0) get 0, which T = 0 erases either way.
"""

from __future__ import annotations

import torch

from relativisticraytracer_tpu_torch.core.vecmath import Vec3
from relativisticraytracer_tpu_torch.ops import cuda_lib
from relativisticraytracer_tpu_torch.render.skybox import Skybox, gather_sky_coords


def _sky_plain(sky: Skybox, idx, fx, fy, effects, masked) -> torch.Tensor:
    coords = tuple(zip(idx, fx, fy))
    bg = gather_sky_coords(sky, coords, effects)
    return torch.stack([torch.where(masked, 0.0, c) for c in bg])


def sky_background_windowed(sky: Skybox, idx: torch.Tensor, fx: torch.Tensor,
                            fy: torch.Tensor, effects, masked: torch.Tensor,
                            lib=None) -> Vec3:
    """Background colour per pixel. `idx`/`fx`/`fy` are the record pass's
    [3, H, W] per-channel (flat quad index, fx, fy) planes (r, g, b);
    `masked` a bool [H, W] plane of pixels whose background cannot reach
    the frame. With chromatic aberration off all channels share the G
    coordinates and one 16-byte q4 row holds the whole footprint.
    csrc/sky.cu for CUDA tensors, the plain version for CPU tensors."""
    device = idx.device
    use_q4 = not (effects.use_chromatic_aberration > 0.5 or sky.q4 is None)
    if device.type == "cuda":
        bg = torch.empty((3,) + tuple(masked.shape), dtype=torch.float32,
                         device=device)
        cuda_lib.resolve(lib).sky(use_q4, idx, fx, fy, masked, sky.qr, sky.qg,
                                  sky.qb, sky.q4, bg,
                                  cuda_lib.current_stream(device))
    elif device.type == "cpu":
        bg = _sky_plain(sky, idx, fx, fy, effects, masked)
    else:
        raise ValueError(f"unsupported device {device}")
    return Vec3(bg[0], bg[1], bg[2])
