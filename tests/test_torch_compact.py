"""PyTorch port: the record and replay passes (ops/pallas_compact.py)
against the JAX package's record kernel (interpret mode, as its own tests
run it), its replay kernel and its XLA march, on the same camera.

Contract: hit mask, sky coordinates and the replayed (I, T). Record
planes are not (the JAX kernel merges gaps inside each 40-step block, the
port records exact per-step segments; both replay to the same (I, T)
because gap steps contribute exact zeros). Tolerances: the hit masks agree
except < 1e-3 of the pixels; quad indices agree where hits do; fx/fy to
1e-4 (a last-ulp change of the escape direction moves them by ~1e-5 on a
128-texel sky); (I, T) to rtol/atol 1e-3 — torch's and XLA's rsqrt, exp,
pow, sin and cos differ in the last ulp, the fbm noise amplifies that,
and XLA's fused CPU code contracts some a*b+c into FMAs."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from relativisticraytracer_tpu.config import CameraEffects as JEffects
from relativisticraytracer_tpu.config import SceneConfig as JScene
from relativisticraytracer_tpu.core.vecmath import normalize as j_normalize
from relativisticraytracer_tpu.ops import pallas_compact as jpc
from relativisticraytracer_tpu.ops.pallas_march import _from_lane_tiles
from relativisticraytracer_tpu.render import camera as jcam
from relativisticraytracer_tpu.render import march as jmarch
from relativisticraytracer_tpu.render.skybox import sky_coords as j_sky_coords
from relativisticraytracer_tpu_torch.config import CameraEffects as TEffects
from relativisticraytracer_tpu_torch.config import SceneConfig as TScene
from relativisticraytracer_tpu_torch.ops import pallas_compact as pc
from relativisticraytracer_tpu_torch.render import camera as tcam

torch.set_num_threads(2)

# camera inside the disk zone: every ray records a media segment at once
W, H, STEPS, T = 128, 16, 64, 2.0
POSE = ((0.0, 1.0, -22.0), 0.0, -2.0)
SKY = (64, 128)


def _unlane(a, h=H, w=W):
    hp = -(-h // jpc.A_BLOCK_H) * jpc.A_BLOCK_H
    wp = -(-w // 128) * 128
    return np.asarray(_from_lane_tiles(a, hp, wp, jpc.A_BLOCK_H, 128))[:h, :w]


@pytest.fixture(scope="module")
def jax_record():
    return jpc.march_pallas_camera_sky_record(
        JScene(max_steps=STEPS), jcam.camera_state_from_pose(*POSE), JEffects(),
        jnp.float32(T), W, H, STEPS, *SKY, slots=3, interpret=True)


@pytest.fixture(scope="module")
def port_record():
    return pc.march_pallas_camera_sky_record(
        TScene(max_steps=STEPS), tcam.camera_state_from_pose(*POSE), TEffects(),
        T, W, H, STEPS, *SKY, slots=3, device="cpu")


def _jax_rec_planes(records):
    return torch.from_numpy(np.stack(
        [np.stack([_unlane(a) for a in slot]) for slot in records]).astype(np.float32))


def test_record_matches_jax_record_kernel_and_xla_march(jax_record, port_record):
    hit, idx3, fx3, fy3, records = jax_record
    rec = port_record
    jhit = _unlane(hit) > 0.5
    thit = rec.hit.numpy() > 0.5
    agree = jhit == thit
    assert (~agree).mean() < 1e-3
    np.testing.assert_array_equal(rec.idx.numpy()[:, agree],
                                  np.stack([_unlane(a) for a in idx3])[:, agree])
    for got, want in ((rec.fx, fx3), (rec.fy, fy3)):
        np.testing.assert_allclose(got.numpy()[:, agree],
                                   np.stack([_unlane(a) for a in want])[:, agree],
                                   rtol=0, atol=1e-4)
    assert (rec.total.numpy() > 0).all()  # the pose reaches the media

    # the same rays through JAX's XLA march: hit mask, and the sky
    # coordinates of its escape directions
    jo, jd, _, _ = jcam.generate_rays(W, H, jcam.camera_state_from_pose(*POSE), JEffects())
    ref = jmarch.march(JScene(max_steps=STEPS), jo, jd, T, STEPS, loop="while")
    assert (np.asarray(ref.hit_horizon) != thit).mean() < 1e-3
    coords = j_sky_coords(j_normalize(ref.v), jnp.float32(0.0), *SKY)
    np.testing.assert_array_equal(rec.idx.numpy()[1], np.asarray(coords[1][0]))

    # the port's replay of JAX's own record planes gives the XLA march's
    # (I, T), with the capture mask applied as the frame does
    inten, trans = pc.media_replay(TScene(max_steps=STEPS), _jax_rec_planes(records), T)
    trans = torch.where(torch.from_numpy(jhit), 0.0, trans)
    pairs = list(zip(inten, ref.intensity)) + [(trans, ref.transmittance)]
    for got, want in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-3, atol=1e-3)
    # and the port's own record replays to the same
    inten2, trans2 = pc.media_replay_sorted(TScene(max_steps=STEPS), rec, T)
    for got, want in zip(list(inten2) + [trans2], list(inten) + [trans]):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-3, atol=1e-3)


@pytest.mark.slow
def test_replay_of_jax_records_matches_jax_replay_kernel(jax_record):
    records = jax_record[4]
    ji, jt = jpc.media_replay(JScene(max_steps=STEPS), records, jnp.float32(T),
                              STEPS, slots=3, interpret=True)
    inten, trans = pc.media_replay(TScene(max_steps=STEPS), _jax_rec_planes(records), T)
    for got, want in zip(list(inten) + [trans], list(ji) + [jt]):
        np.testing.assert_allclose(got.numpy(), _unlane(want), rtol=1e-3, atol=1e-3)


def test_wrappers_reject_bad_inputs(port_record):
    scene = TScene(max_steps=STEPS)
    with pytest.raises(ValueError, match="slots"):
        pc.march_pallas_camera_sky_record(scene, tcam.default_camera(), TEffects(), 0.0,
                                          8, 4, 4, *SKY, slots=0, device="cpu")
    with pytest.raises(ValueError, match="device"):
        pc.march_pallas_camera_sky_record(scene, tcam.default_camera(), TEffects(), 0.0,
                                          8, 4, 4, *SKY, device="meta")
    with pytest.raises(ValueError, match="int32"):
        pc.media_replay(scene, port_record.rec, T, order=torch.arange(4))
    with pytest.raises(ValueError, match="slots, 7"):
        pc.media_replay(scene, port_record.rec[0], T)
    assert pc.replay_order(torch.zeros(3, 4)).numel() == 0
    inten, trans = pc.media_replay(scene, port_record.rec, T,
                                   order=torch.zeros(0, dtype=torch.int32))
    assert float(trans.min()) == 1.0 and float(inten.x.abs().max()) == 0.0
