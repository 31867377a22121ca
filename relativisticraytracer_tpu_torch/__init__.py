"""relativisticraytracer_tpu_torch — the relativistic black-hole renderer
on PyTorch, with hand-written CUDA kernels for NVIDIA Hopper.

A port of relativisticraytracer_tpu (JAX/Pallas), which stays the
reference. The frame programs run the record, replay, sky and fused
march kernels (csrc/) on a CUDA device, the default, and their plain
PyTorch versions on the CPU when the caller asks for it. The host runtime
(`runtime/`: session, animation jobs, frame sink, preview; `io/`; `paths`)
and the CLI (`python -m relativisticraytracer_tpu_torch`) drive them;
`tools/` holds the two measurement probes (csrc/probes.cu).
"""

from relativisticraytracer_tpu_torch.config import (
    DEFAULT_SCENE,
    CameraEffects,
    RenderSettings,
    SceneConfig,
)
from relativisticraytracer_tpu_torch.render.camera import (
    CameraState,
    camera_state_from_pose,
)
from relativisticraytracer_tpu_torch.render.pipeline import Renderer, render_frame

__version__ = "0.1.0"

__all__ = [
    "SceneConfig",
    "CameraEffects",
    "RenderSettings",
    "DEFAULT_SCENE",
    "CameraState",
    "camera_state_from_pose",
    "Renderer",
    "render_frame",
]
