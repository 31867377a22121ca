"""PyTorch port: spatial shards over a device grid (parallel/sharding.py)
on grids of CPU devices, run one after another. As in the JAX package's
tests/test_sharding.py, a tiled frame must equal the untiled one byte for
byte, in both branches: compact (record/replay/sky per shard, with the
shard's origin and strips in the record kernel's ray generation) and
inline (the plane march on the shard's slice of the full frame's rays).
The strip arithmetic must equal the JAX package's on the same ints."""

import numpy as np
import pytest
import torch

from relativisticraytracer_tpu.config import RenderSettings as JSettings
from relativisticraytracer_tpu.config import SceneConfig as JScene
from relativisticraytracer_tpu.parallel import sharding as jsh
from relativisticraytracer_tpu_torch.config import CameraEffects as TEffects
from relativisticraytracer_tpu_torch.config import RenderSettings as TSettings
from relativisticraytracer_tpu_torch.config import SceneConfig as TScene
from relativisticraytracer_tpu_torch.core.vecmath import Vec3, normalize
from relativisticraytracer_tpu_torch.ops import pallas_compact as pc
from relativisticraytracer_tpu_torch.ops import pallas_march as pm
from relativisticraytracer_tpu_torch.parallel import sharding as tsh
from relativisticraytracer_tpu_torch.render import camera as tcam
from relativisticraytracer_tpu_torch.render import skybox as tsky
from relativisticraytracer_tpu_torch.render.pipeline import Renderer
from relativisticraytracer_tpu_torch.render.skybox import skybox_from_array

torch.set_num_threads(2)

SKY = skybox_from_array(
    np.load(__import__("pathlib").Path(__file__).resolve().parent / "torch_data"
            / "starfield_64x128.npy"), "cpu")
POSE = ((0.0, 5.0, -38.0), 0.0, -6.0)
STEPS = 120
FX = TEffects(use_lens_distortion=1.0, distortion_amount=-0.15,
              use_chromatic_aberration=1.0, ca_amount=0.004, use_vignette=1.0)


def _frames(media_pass, shape, effects=TEffects(), ss=1, interleave="auto", **scene_kw):
    """(reassembled sharded frame, single-device frame) as numpy."""
    scene = TScene(max_steps=STEPS, **scene_kw)
    settings = TSettings(width=32, height=24, max_steps=STEPS, media_pass=media_pass,
                         supersample=ss)
    cam = tcam.camera_state_from_pose(*POSE)
    mesh = tsh.make_mesh(["cpu"] * (shape[0] * shape[1]), shape)
    fn = tsh.make_sharded_renderer(scene, settings, mesh, interleave=interleave)
    frame = fn(cam, effects, 1.0, SKY)
    assert frame.shape == (24, 32, 4) and frame.dtype == torch.uint8
    whole = Renderer(scene, settings, skybox=SKY, device="cpu").render(cam, effects, 1.0)
    return fn.reassemble(frame), whole.numpy()


@pytest.mark.parametrize("media_pass", ["compact", "inline"])
@pytest.mark.parametrize("shape", [(2, 1), (1, 2), (2, 2)])
def test_tiled_equals_untiled(media_pass, shape):
    tiled, untiled = _frames(media_pass, shape)
    np.testing.assert_array_equal(tiled, untiled)


@pytest.mark.parametrize("shape,effects,ss,interleave", [
    ((2, 1), FX, 1, False),    # contiguous compact, offset-dependent uv paths
    ((1, 4), TEffects(), 1, True),  # column strips (nx > 2)
    ((2, 1), TEffects(), 2, True),  # strips are multiples of the supersample
])
def test_compact_shards_with_effects_strips_and_supersample(shape, effects, ss, interleave):
    tiled, untiled = _frames("compact", shape, effects, ss, interleave)
    np.testing.assert_array_equal(tiled, untiled)


@pytest.mark.parametrize("effects", [TEffects(), FX], ids=["ca_off", "ca_on"])
@pytest.mark.parametrize("media_pass,scene_kw", [
    ("inline", {}),
    ("compact", dict(enable_disk=False, enable_clouds=False)),  # no medium: plane tiles
], ids=["inline", "no_medium"])
def test_plane_tiles_through_the_sky_call_equal_untiled(media_pass, scene_kw, effects):
    """The non-compact tiles fetch their sky through the sky kernel's
    call (tile_background) and stay bitwise the untiled frame."""
    tiled, untiled = _frames(media_pass, (2, 2), effects, interleave=False, **scene_kw)
    np.testing.assert_array_equal(tiled, untiled)


@pytest.mark.parametrize("ca", [0.0, 1.0], ids=["ca_off", "ca_on"])
def test_tile_background_equals_sample_sky_fast(ca):
    """The plane tile's background (sky coordinates + the sky kernel's
    plain version) is bitwise the sample_sky_fast it replaced, on a
    march's final velocities and on random unnormalised directions."""
    effects = TEffects(use_chromatic_aberration=ca, ca_amount=0.004)
    cam = tcam.camera_state_from_pose(*POSE)
    origin, direction, _, _ = tcam.generate_rays(24, 16, cam, effects, "cpu")
    _, _, _, vel = pm.march_pallas(TScene(max_steps=STEPS), origin, direction, 1.0, STEPS)
    rng = np.random.default_rng(7)
    rand = Vec3(*(torch.from_numpy(rng.normal(size=(16, 24)).astype(np.float32) * 40.0)
                  for _ in range(3)))
    for v in (vel, rand):
        got = tsh.tile_background(SKY, v, effects)
        want = tsky.sample_sky_fast(SKY, normalize(v), effects)
        for g, w in zip(got, want):
            assert torch.equal(g, w)


def test_shard_record_is_a_crop_of_the_full_record():
    """The record pass of a strip-interleaved shard, origin and strips in
    its ray generation, is bitwise the matching rows/columns of the full
    frame's record."""
    scene = TScene(max_steps=STEPS)
    cam = tcam.camera_state_from_pose(*POSE)
    full = pc.march_pallas_camera_sky_record(scene, cam, FX, 1.0, 32, 24, STEPS, 64, 128,
                                             device="cpu")
    # shard (1, 1) of a (2, 2) grid with 6-row strips and 4-column strips
    rows = [(r // 6) * 12 + r % 6 + 6 for r in range(12)]
    cols = [(c // 4) * 8 + c % 4 + 4 for c in range(16)]
    shard = pc.march_pallas_camera_sky_record(
        scene, cam, FX, 1.0, 16, 12, STEPS, 64, 128, device="cpu", origin=(4.0, 6.0),
        img_w=32, img_h=24, strips=(6, 12), cstrips=(4, 8))
    for got, want in zip(shard, full):
        assert torch.equal(got, want[..., rows, :][..., cols])
    with pytest.raises(ValueError, match="together"):
        pc.march_pallas_camera_sky_record(scene, cam, FX, 1.0, 16, 12, STEPS, 64, 128,
                                          device="cpu", origin=(4.0, 6.0))


def test_strip_arithmetic_equals_jax():
    for extent, n, ss, target in [(1080, 4, 1, 16), (1920, 2, 1, 128), (64, 8, 2, 16),
                                  (48, 2, 1, 16), (24, 2, 3, 16), (1920, 4, 1, 128)]:
        assert tsh.strip_height(extent, n, ss, target) == jsh.strip_height(extent, n, ss,
                                                                            target)
    with pytest.raises(ValueError):
        tsh.strip_height(10, 3)
    rng = np.random.default_rng(3)
    for ny, nx, sh, sw in [(4, 2, 6, 0), (2, 4, 3, 2), (1, 8, 0, 1), (2, 2, 1, 1)]:
        frame = rng.integers(0, 255, (24, 32, 4), dtype=np.uint8)
        np.testing.assert_array_equal(tsh.reassemble_strips(frame, ny, nx, sh, sw),
                                      jsh.reassemble_strips(frame, ny, nx, sh, sw))
    for (ny, nx), ss in [((4, 2), 1), ((2, 4), 1), ((1, 8), 2), ((8, 1), 1)]:
        kw = dict(width=1920, height=1080, supersample=ss)
        jmesh = type("M", (), {"devices": np.empty((ny, nx))})()
        tmesh = tsh.make_mesh(["cpu"] * (ny * nx), (ny, nx))
        assert tsh.interleave_params(TSettings(**kw), tmesh) == jsh.interleave_params(
            JSettings(**kw), jmesh)
        for interleave in ("auto", True, False):
            assert tsh.shard_settings(TSettings(**kw), ny, nx, interleave).media_capacity == \
                jsh.shard_settings(JSettings(**kw), ny, nx, interleave).media_capacity
    for scene_kw in (dict(), dict(enable_disk=False, enable_clouds=False)):
        for media_pass in ("compact", "inline"):
            for interleave in ("auto", True, False):
                assert tsh.resolve_interleave(
                    TScene(**scene_kw), TSettings(media_pass=media_pass), interleave
                ) == jsh.resolve_interleave(
                    JScene(**scene_kw), JSettings(loop="pallas", media_pass=media_pass),
                    interleave)


def test_render_on_keeps_one_sky_replica_per_device():
    """Renderer.render_on renders on the device it is given with that
    device's copy of the sky, uploaded once (JAX pipeline.py:147-170)."""
    scene = TScene(max_steps=STEPS)
    r = Renderer(scene, TSettings(width=16, height=8, max_steps=STEPS), skybox=SKY,
                 device="cpu")
    cam = tcam.camera_state_from_pose(*POSE)
    assert torch.equal(r.render_on("cpu", cam, TEffects(), 1.0), r.render(cam, TEffects(), 1.0))
    meta = torch.device("meta")
    replica = r._sky_on(meta)
    assert replica is r._sky_on(meta) and replica.qr.device == meta
    assert r._sky_on(torch.device("cpu")) is r.sky


def test_mesh_and_argument_checks():
    mesh = tsh.make_mesh(["cpu"] * 6)
    assert mesh.shape == (3, 2) and all(d == torch.device("cpu") for d in mesh.devices.flat)
    with pytest.raises(ValueError, match="mesh shape"):
        tsh.make_mesh(["cpu"] * 6, (4, 2))
    scene = TScene(max_steps=STEPS)
    cam = tcam.camera_state_from_pose(*POSE)
    with pytest.raises(ValueError, match="divisible"):
        tsh.render_frame_sharded(scene, TSettings(width=31, height=24), tsh.make_mesh(
            ["cpu"] * 2, (1, 2)), cam, TEffects(), 0.0, SKY)
    mesh = tsh.make_mesh(["cpu"] * 2, (2, 1))
    for settings, sky in ((TSettings(width=32, height=24, media_pass="inline"), SKY),
                          (TSettings(width=32, height=24), None)):
        with pytest.raises(ValueError, match="compact"):
            tsh.render_frame_sharded(scene, settings, mesh, cam, TEffects(), 0.0, sky,
                                     interleave=True)
