"""PyTorch port: the plain masked march (render/march.py) against the JAX
package's XLA march (`render/march.march`, loop="while") on the same rays.

Rays come from each package's own generate_rays (bitwise equal up to the
few-ulp normalize, test_torch_core). The hit masks must agree on all but
< 1e-3 of the pixels; (I, T) and the final velocity are compared where
they agree. Tolerance: torch's and XLA's rsqrt/exp/pow/sin/cos differ in
the last ulp, the march compounds that over hundreds of RK4 steps and the
noise domain warp amplifies it — measured ≲2e-4 absolute on intensities of
order 1, so atol 1e-3 / rtol 1e-3 (a frame's 8-bit quantum is 3.9e-3)."""

import numpy as np
import pytest
import torch

from relativisticraytracer_tpu.config import CameraEffects as JEffects
from relativisticraytracer_tpu.config import SceneConfig as JScene
from relativisticraytracer_tpu.render import camera as jcam
from relativisticraytracer_tpu.render import march as jmarch
from relativisticraytracer_tpu_torch.config import CameraEffects as TEffects
from relativisticraytracer_tpu_torch.config import SceneConfig as TScene
from relativisticraytracer_tpu_torch.render import camera as tcam
from relativisticraytracer_tpu_torch.render import march as tmarch

torch.set_num_threads(2)

# name: (pose, time, width, height, steps, scene kwargs)
CASES = {
    # crosses the disk and cloud layers edge-on: media on ~3% of rays
    "edge_media": (((0.0, 0.8, -40.0), 0.0, 0.0), 2.0, 64, 32, 128, {}),
    # close to the hole, vacuum: ~8% of rays are captured within the cap
    "capture": (((0.0, 2.0, -12.0), 0.0, -5.0), 1.0, 32, 16, 700,
                dict(enable_disk=False, enable_clouds=False)),
}


def _rays(case):
    pose, t, w, h, steps, kw = CASES[case]
    jo, jd, _, _ = jcam.generate_rays(w, h, jcam.camera_state_from_pose(*pose), JEffects())
    to, td, _, _ = tcam.generate_rays(w, h, tcam.camera_state_from_pose(*pose),
                                      TEffects(), "cpu")
    return (jo, jd), (to, td), torch.tensor(t, dtype=torch.float32)


def _march_both(case, spin):
    _, t, _, _, steps, kw = CASES[case]
    (jo, jd), (to, td), tt = _rays(case)
    js = jmarch.march(JScene(max_steps=steps, spin_a=spin, **kw), jo, jd, t, steps,
                      loop="while")
    ts = tmarch.march(TScene(max_steps=steps, spin_a=spin, **kw), to, td, tt, steps)
    return js, ts


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("spin", [0.0, 0.9])
def test_plain_march_matches_jax_while_march(case, spin):
    js, ts = _march_both(case, spin)
    jhit, thit = np.asarray(js.hit_horizon), ts.hit_horizon.numpy()
    agree = jhit == thit
    assert (~agree).mean() < 1e-3
    if case == "capture":
        assert jhit.mean() > 0.02  # the case really exercises capture
    else:
        assert (np.asarray(js.transmittance) < 1.0).mean() > 0.01  # and media
    np.testing.assert_array_equal(np.asarray(js.active), ts.active.numpy())
    pairs = list(zip(ts.intensity, js.intensity)) + [(ts.transmittance, js.transmittance)]
    pairs += list(zip(ts.v, js.v))
    for got, want in pairs:
        np.testing.assert_allclose(got.numpy()[agree], np.asarray(want)[agree],
                                   rtol=1e-3, atol=1e-3)
    # captured rays are black: transmittance exactly 0
    assert (ts.transmittance.numpy()[thit] == 0.0).all()


def test_render_hdr_composites_like_jax():
    """March + background: black where captured, I + bg*T elsewhere, with
    a background function of the escape direction."""
    _, t, _, _, steps, kw = CASES["capture"]
    (jo, jd), (to, td), tt = _rays("capture")
    jhdr, js = jmarch.render_hdr(
        JScene(max_steps=steps, **kw), jo, jd, t,
        lambda d: jmarch.Vec3(0.5 + 0.0 * d.x, 0.25 + d.y, 1.0 + d.z),
        max_steps=steps, loop="while")
    thdr, ts = tmarch.render_hdr(
        TScene(max_steps=steps, **kw), to, td, tt,
        lambda d: tmarch.Vec3(0.5 + 0.0 * d.x, 0.25 + d.y, 1.0 + d.z),
        max_steps=steps)
    agree = np.asarray(js.hit_horizon) == ts.hit_horizon.numpy()
    for got, want in zip(thdr, jhdr):
        np.testing.assert_allclose(got.numpy()[agree], np.asarray(want)[agree],
                                   rtol=1e-3, atol=1e-3)
    hit = ts.hit_horizon.numpy()
    assert hit.any()
    for c in thdr:  # vacuum: captured rays are exactly black
        assert (c.numpy()[hit] == 0.0).all()


def test_march_step_cap_and_working_set_are_exact():
    """Dropping finished rays from the working set every CHUNK steps, and
    the chunk boundary itself, change nothing: chunk=1 and chunk=64 give
    bitwise the same state."""
    _, (to, td), tt = _rays("edge_media")
    a = tmarch.march(TScene(max_steps=96), to, td, tt, 96, chunk=1)
    b = tmarch.march(TScene(max_steps=96), to, td, tt, 96, chunk=64)
    for x, y in zip(list(a.p) + list(a.v) + list(a.intensity) + [a.transmittance],
                    list(b.p) + list(b.v) + list(b.intensity) + [b.transmittance]):
        assert torch.equal(x, y)
    assert torch.equal(a.hit_horizon, b.hit_horizon)
    assert torch.equal(a.active, b.active)
