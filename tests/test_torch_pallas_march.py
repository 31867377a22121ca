"""PyTorch port: the fused inline march (ops/pallas_march.py) against the
JAX package, on the CPU where each wrapper runs its plain version
(render/march.march); the inline frame against the compact one, and the
default program's dispatch. Frames against the JAX package's frames are
in tests/test_torch_inline_frames.py.

Tolerances, measured on these inputs (16x16 numpy rays, 200 steps):
- vacuum Schwarzschild: (I, T) bitwise, v within 8.4e-7 of XLA's march,
  inside rtol 2e-6 / atol 5e-7 (tests/test_compact.py:180);
- with media or spin: the trajectory and the hit mask agree (no hit
  mismatch), but torch's CPU exp/pow/sin/cos/rsqrt differ from XLA's in
  the last ulp and the fbm noise and the Kerr frame dragging amplify
  that: max |dI| 5.1e-5, max |dv| 1.1e-5 (Kerr 0.9). Those cases are
  held to rtol 1e-3 / atol 1e-4, as tests/test_torch_march.py holds the
  plain march.
The kernels themselves are held to the strict bar against these plain
versions on the card (tests/test_torch_kernels_gpu.py, chip_smoke.py).
"""

import pathlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from relativisticraytracer_tpu.config import SceneConfig as JScene
from relativisticraytracer_tpu.core.vecmath import Vec3 as JVec3
from relativisticraytracer_tpu.core.vecmath import normalize as j_normalize
from relativisticraytracer_tpu.render import camera as jcam
from relativisticraytracer_tpu.render import march as jmarch
from relativisticraytracer_tpu.render.skybox import sky_coords as j_sky_coords
from relativisticraytracer_tpu_torch.config import CameraEffects as TEffects
from relativisticraytracer_tpu_torch.config import RenderSettings as TSettings
from relativisticraytracer_tpu_torch.config import SceneConfig as TScene
from relativisticraytracer_tpu_torch.core.vecmath import Vec3 as TVec3
from relativisticraytracer_tpu_torch.ops import pallas_compact as pc
from relativisticraytracer_tpu_torch.ops import pallas_march as pm
from relativisticraytracer_tpu_torch.render import camera as tcam
from relativisticraytracer_tpu_torch.render.pipeline import Renderer
from relativisticraytracer_tpu_torch.render.skybox import skybox_from_array

torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parent
SKY = np.load(ROOT / "torch_data" / "starfield_64x128.npy")
STEPS = 200
SCENES = {
    "full": {},
    "vacuum": dict(enable_disk=False, enable_clouds=False),
    "kerr09": dict(spin_a=0.9),
    "clouds_only": dict(enable_disk=False),
}
FRAME_POSE = ((0.0, 3.0, -30.0), 0.0, -6.0)
FRAME_STEPS = 160


def _numpy_rays(seed=0, h=16, w=16):
    """Origins 6-28 units in front of the hole, directions roughly inward:
    some rays are captured, some cross the disk and cloud layers."""
    rng = np.random.default_rng(seed)
    o = np.stack([rng.normal(0, 2, (h, w)), rng.normal(0, 1, (h, w)),
                  rng.uniform(-28, -6, (h, w))])
    d = -o / np.linalg.norm(o, axis=0, keepdims=True) + rng.normal(0, 0.25, (3, h, w))
    d /= np.linalg.norm(d, axis=0, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32)


@pytest.mark.parametrize("name", list(SCENES))
def test_march_pallas_matches_jax_march(name):
    kw = SCENES[name]
    o, d = _numpy_rays()
    js = jmarch.march(JScene(max_steps=STEPS, **kw), JVec3(*map(jnp.asarray, o)),
                      JVec3(*map(jnp.asarray, d)), 2.0, STEPS, loop="while")
    inten, trans, hit, vel = pm.march_pallas(
        TScene(max_steps=STEPS, **kw), TVec3(*map(torch.from_numpy, o)),
        TVec3(*map(torch.from_numpy, d)), 2.0, STEPS)
    jhit = np.asarray(js.hit_horizon)
    assert hit.dtype == torch.bool and 0.0 < jhit.mean() < 1.0
    agree = jhit == hit.numpy()
    assert (~agree).mean() < 1e-3
    assert (trans.numpy()[hit.numpy()] == 0.0).all()  # captured: T exactly 0
    strict = dict(rtol=2e-6, atol=5e-7)
    shaded = strict if name == "vacuum" else dict(rtol=1e-3, atol=1e-4)
    pairs = [(a, b, shaded) for a, b in zip(inten, js.intensity)]
    pairs.append((trans, js.transmittance, shaded))
    pairs += [(a, b, strict if name != "kerr09" else shaded) for a, b in zip(vel, js.v)]
    for got, want, tol in pairs:
        np.testing.assert_allclose(got.numpy()[agree], np.asarray(want)[agree], **tol)
    if name != "vacuum":
        assert (trans.numpy() < 1.0).mean() > 0.05  # the rays really cross media


def test_march_camera_sky_coords_match_jax_sky_coords():
    """The sky epilogue: the coordinates march_pallas_camera_sky returns are
    JAX's sky_coords of the same final velocity (CA on: three channel
    sets); its (I, T) are march_pallas_camera's."""
    scene = TScene(max_steps=STEPS)
    cam = tcam.camera_state_from_pose(*FRAME_POSE)
    eff = TEffects(use_chromatic_aberration=1.0, ca_amount=0.01)
    inten, trans, idx, fx, fy = pm.march_pallas_camera_sky(
        scene, cam, eff, 1.5, 16, 8, STEPS, 64, 128, device="cpu")
    inten2, trans2, hit, vel = pm.march_pallas_camera(scene, cam, eff, 1.5, 16, 8, STEPS,
                                                      device="cpu")
    for a, b in zip(list(inten) + [trans], list(inten2) + [trans2]):
        assert torch.equal(a, b)
    assert idx.dtype == torch.int32 and idx.shape == (3, 8, 16)
    coords = j_sky_coords(j_normalize(JVec3(*(jnp.asarray(c.numpy()) for c in vel))),
                          jnp.float32(0.01), 64, 128)
    for ch, (jidx, jfx, jfy) in enumerate(coords):
        np.testing.assert_array_equal(idx[ch].numpy(), np.asarray(jidx))
        np.testing.assert_allclose(fx[ch].numpy(), np.asarray(jfx), rtol=0, atol=1e-5)
        np.testing.assert_allclose(fy[ch].numpy(), np.asarray(jfy), rtol=0, atol=1e-5)


@pytest.mark.parametrize("slots", [3, 1])
def test_inline_frame_equals_compact_frame(slots):
    """Record + replay is the inline march split in two: the same frame
    byte for byte, also when later crossings merge into one slot."""
    scene = TScene(max_steps=FRAME_STEPS)
    cam = tcam.camera_state_from_pose((0.0, 5.0, -38.0), 0.0, -6.0)
    sky = skybox_from_array(SKY, "cpu")
    frames = [Renderer(scene, TSettings(width=32, height=24, max_steps=FRAME_STEPS,
                                        media_pass=mp, media_slots=slots),
                       skybox=sky, device="cpu").render(cam, TEffects(), 2.0)
              for mp in ("compact", "inline")]
    assert torch.equal(frames[0], frames[1])


@pytest.mark.parametrize("scene_kw,sky", [
    (dict(enable_disk=False, enable_clouds=False), True),  # no medium
    (dict(), False),                                       # no sky
    (dict(), True),                                        # compact
])
def test_compact_dispatch_takes_the_inline_frame(monkeypatch, scene_kw, sky):
    """As in the JAX package (pallas_compact.py:872-874): with no sky or no
    medium the default program is the fused inline march."""
    calls = []
    inline = pc.render_frame_pallas

    def spy(*args, **kwargs):
        calls.append(args[5] is not None)
        return inline(*args, **kwargs)

    monkeypatch.setattr(pc, "render_frame_pallas", spy)
    r = Renderer(TScene(max_steps=8, **scene_kw), TSettings(width=8, height=4),
                 skybox_rgba=SKY if sky else None, device="cpu")
    frame = r.render(tcam.default_camera())
    assert frame.shape == (4, 8, 4)
    inline_expected = not (sky and scene_kw == {})
    assert calls == ([sky] if inline_expected else [])


def test_entry_points_default_to_the_card_and_check_devices():
    """No device named means the card; an unsupported device is an error
    before any work."""
    assert Renderer(TScene(), TSettings()).device == torch.device("cuda")
    assert Renderer(TScene(), TSettings(), device="cpu").device == torch.device("cpu")
    cam = tcam.default_camera()
    with pytest.raises(ValueError, match="device"):
        pm.march_pallas_camera(TScene(), cam, TEffects(), 0.0, 8, 4, 4, device="meta")
    with pytest.raises(ValueError, match="device"):
        pm.march_pallas_camera_sky(TScene(), cam, TEffects(), 0.0, 8, 4, 4, 64, 128,
                                   device="meta")
    z = torch.zeros((4, 8), device="meta")
    with pytest.raises(ValueError, match="device"):
        pm.march_pallas(TScene(), TVec3(z, z, z), TVec3(z, z, z), 0.0, 4)
