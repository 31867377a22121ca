"""PyTorch port: the inline frame (ops/pallas_march.render_frame_pallas)
on the CPU, where it runs the plain march, against the JAX package's
frames: its XLA frame (render/pipeline.render_frame, loop="while") and, in
the slow tier, its own Pallas kernel in interpret mode."""

import pathlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from relativisticraytracer_tpu.config import CameraEffects as JEffects
from relativisticraytracer_tpu.config import RenderSettings as JSettings
from relativisticraytracer_tpu.config import SceneConfig as JScene
from relativisticraytracer_tpu.config import effects_off as j_effects_off
from relativisticraytracer_tpu.render import camera as jcam
from relativisticraytracer_tpu.render.pipeline import Renderer as JRenderer
from relativisticraytracer_tpu_torch.config import CameraEffects as TEffects
from relativisticraytracer_tpu_torch.config import RenderSettings as TSettings
from relativisticraytracer_tpu_torch.config import SceneConfig as TScene
from relativisticraytracer_tpu_torch.config import effects_off as t_effects_off
from relativisticraytracer_tpu_torch.ops import pallas_march as pm
from relativisticraytracer_tpu_torch.render import camera as tcam
from relativisticraytracer_tpu_torch.render.skybox import skybox_from_array

torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parent
SKY = np.load(ROOT / "torch_data" / "starfield_64x128.npy")
# 32x24, the inline-fallback pose of tests/test_torch_pipeline.py
FRAME_POSE = ((0.0, 3.0, -30.0), 0.0, -6.0)
FRAME_STEPS = 160


def _rmse(a, b) -> float:
    d = a[..., :3].astype(np.int64) - b[..., :3].astype(np.int64)
    return float(np.sqrt(np.mean((d / 255.0) ** 2)))


@pytest.mark.parametrize("case", ["sky", "no_sky", "supersample2", "chromatic"])
def test_render_frame_pallas_matches_jax_render_frame(case):
    """The inline frame against JAX's XLA frame (loop="while"). Measured
    RMSE on these 32x24 frames: sky 0, no_sky 0, supersample2 0,
    chromatic 0 (expected ≲ 1e-4: the shading differs by < 1e-4 absolute,
    a fraction of an 8-bit level)."""
    sky = case != "no_sky"
    ss = 2 if case == "supersample2" else 1
    jeff, teff = JEffects(), TEffects()
    if case == "chromatic":
        jeff = JEffects(use_chromatic_aberration=1.0, ca_amount=0.01)
        teff = TEffects(use_chromatic_aberration=1.0, ca_amount=0.01)
    if case == "supersample2":
        jeff, teff = j_effects_off(), t_effects_off()
    settings = dict(width=32, height=24, max_steps=FRAME_STEPS, supersample=ss)
    want = JRenderer(JScene(max_steps=FRAME_STEPS), JSettings(loop="while", **settings),
                     skybox_rgba=SKY if sky else None).render_np(
        jcam.camera_state_from_pose(*FRAME_POSE), jeff, 0.5)
    got = pm.render_frame_pallas(
        TScene(max_steps=FRAME_STEPS), TSettings(media_pass="inline", **settings),
        tcam.camera_state_from_pose(*FRAME_POSE), teff, 0.5,
        skybox_from_array(SKY, "cpu") if sky else None, device="cpu")
    assert got.dtype == torch.uint8 and got.shape == (24, 32, 4)
    assert _rmse(got.numpy(), want) < 1e-3
    assert np.abs(got.numpy().astype(int) - want.astype(int)).max() <= 1


@pytest.mark.slow
def test_inline_frame_matches_jax_pallas_interpret():
    """The port's inline frame against the JAX package's own Pallas kernel
    (interpret mode) at 32x32 with 64 steps."""
    from relativisticraytracer_tpu.ops.pallas_march import render_frame_pallas
    from relativisticraytracer_tpu.render.skybox import skybox_from_array as j_sky

    pose = ((0.0, 1.0, -22.0), 0.0, -2.0)  # inside the disk zone: media at once
    settings = dict(width=32, height=32, max_steps=64)
    want = np.asarray(render_frame_pallas(
        JScene(max_steps=64), JSettings(loop="pallas", media_pass="inline", **settings),
        jcam.camera_state_from_pose(*pose), JEffects(), jnp.float32(1.0), j_sky(SKY),
        interpret=True))
    got = pm.render_frame_pallas(
        TScene(max_steps=64), TSettings(media_pass="inline", **settings),
        tcam.camera_state_from_pose(*pose), TEffects(), 1.0,
        skybox_from_array(SKY, "cpu"), device="cpu").numpy()
    assert _rmse(got, want) < 1e-3
