"""PyTorch port: core math, physics, media, camera and post FX against the
JAX package on the same numpy-seeded inputs.

Tolerances: ops built from mul/add/trunc/floor/select only are held
bitwise. Where XLA and torch call different transcendental or reciprocal
kernels (XLA's CPU rsqrt rewrite of 1/sqrt, exp, pow, sin, cos) the spread
is reported in ulp or as an absolute band, with the reason beside it."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from relativisticraytracer_tpu.config import CameraEffects as JEffects
from relativisticraytracer_tpu.config import SceneConfig as JScene
from relativisticraytracer_tpu.core import fastmath as jf
from relativisticraytracer_tpu.core import noise as jn
from relativisticraytracer_tpu.core import utils as ju
from relativisticraytracer_tpu.core import vecmath as jv
from relativisticraytracer_tpu.media import densities as jd
from relativisticraytracer_tpu.physics import geodesics as jg
from relativisticraytracer_tpu.physics import integrators as ji
from relativisticraytracer_tpu.render import camera as jcam
from relativisticraytracer_tpu.render import postfx as jpost
from relativisticraytracer_tpu_torch.config import CameraEffects as TEffects
from relativisticraytracer_tpu_torch.config import SceneConfig as TScene
from relativisticraytracer_tpu_torch.core import fastmath as tf
from relativisticraytracer_tpu_torch.core import noise as tn
from relativisticraytracer_tpu_torch.core import utils as tu
from relativisticraytracer_tpu_torch.core import vecmath as tv
from relativisticraytracer_tpu_torch.media import densities as td
from relativisticraytracer_tpu_torch.physics import geodesics as tg
from relativisticraytracer_tpu_torch.physics import integrators as ti
from relativisticraytracer_tpu_torch.render import camera as tcam
from relativisticraytracer_tpu_torch.render import postfx as tpost

torch.set_num_threads(2)

N = 4096


def _vec(a):
    """numpy [3, N] -> (JAX Vec3, torch Vec3) of the same float32 values."""
    a = np.ascontiguousarray(a, np.float32)
    return (jv.Vec3(*(jnp.asarray(c) for c in a)),
            tv.Vec3(*(torch.from_numpy(c.copy()) for c in a)))


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _ulp(a, b) -> int:
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return int(np.abs(a.view(np.int32).astype(np.int64)
                      - b.view(np.int32).astype(np.int64)).max())


@pytest.fixture
def pq(rng):
    return (_vec(rng.standard_normal((3, N)) * 30.0),
            _vec(rng.standard_normal((3, N))))


def test_vecmath_matches_jax(pq, rng):
    (jp, tp), (jq, tq) = pq
    np.testing.assert_array_equal(_np(tv.dot(tp, tq)), _np(jv.dot(jp, jq)))
    for a, b in zip(tv.cross(tp, tq), jv.cross(jp, jq)):
        np.testing.assert_array_equal(_np(a), _np(b))
    # XLA's CPU sqrt and its rsqrt rewrite of 1/sqrt are not correctly
    # rounded: a few ulp
    assert _ulp(_np(tv.length(tp)), _np(jv.length(jp))) <= 2
    for a, b in zip(tv.normalize(tq), jv.normalize(jq)):
        assert _ulp(_np(a), _np(b)) <= 4
    zero = tv.normalize(tv.vec3(1e-7, 0.0, 0.0))
    assert float(zero.x) == 0.0
    x = rng.uniform(-1, 2, N).astype(np.float32)
    np.testing.assert_array_equal(
        _np(tv.smoothstep(0.8, 0.2, torch.from_numpy(x))),
        _np(jv.smoothstep(0.8, 0.2, jnp.asarray(x))))
    np.testing.assert_array_equal(
        _np(tv.lerp(torch.from_numpy(x), 2.0, 0.25)), _np(jv.lerp(jnp.asarray(x), 2.0, 0.25)))
    ang = 0.7
    for a, b in zip(tv.rotate_3d(tp, tv.normalize(tq), ang),
                    jv.rotate_3d(jp, jv.normalize(jq), jnp.float32(ang))):
        np.testing.assert_allclose(_np(a), _np(b), rtol=1e-5, atol=1e-4)
    assert [tu.largest_divisor_at_most(n, k) for n, k in ((2000, 40), (7, 3), (9, 0))] == \
        [ju.largest_divisor_at_most(n, k) for n, k in ((2000, 40), (7, 3), (9, 0))]


def test_fastmath_matches_jax(pq, rng):
    (jp, tp), (jq, tq) = pq
    # mul/add/div/select only: bitwise
    np.testing.assert_array_equal(_np(tf.atan2(tp.y, tp.x)), _np(jf.atan2(jp.y, jp.x)))
    edge = np.array([0.0, -0.0, 1.0, -1.0, 0.0, 3.0], np.float32)
    np.testing.assert_array_equal(
        _np(tf.atan2(torch.from_numpy(edge), torch.from_numpy(edge[::-1].copy()))),
        _np(jf.atan2(jnp.asarray(edge), jnp.asarray(edge[::-1].copy()))))
    # arcsin goes through sqrt(1 - x^2), which XLA may fuse differently: 1 ulp
    x = rng.uniform(-1.2, 1.2, N).astype(np.float32)
    assert _ulp(_np(tf.arcsin(torch.from_numpy(x))), _np(jf.arcsin(jnp.asarray(x)))) <= 2


@pytest.mark.parametrize("octaves", [1, 5])
def test_noise_bitwise(pq, octaves):
    (jp, tp), _ = pq
    np.testing.assert_array_equal(_np(tn.hash31(tp)), _np(jn.hash31(jp)))
    for a, b in zip(tn.hash33(tp), jn.hash33(jp)):
        np.testing.assert_array_equal(_np(a), _np(b))
    np.testing.assert_array_equal(_np(tn.noise3D(tp)), _np(jn.noise3D(jp)))
    np.testing.assert_array_equal(_np(tn.fbm(tp, octaves)), _np(jn.fbm(jp, octaves)))
    np.testing.assert_array_equal(_np(tn.fbm_billow(tp, octaves)),
                                  _np(jn.fbm_billow(jp, octaves)))


def test_worley_within_two_ulp(pq):
    (jp, tp), _ = pq
    # the sqrt of the distance is the only non-exact op
    assert _ulp(_np(tn.worley3D(tp)), _np(jn.worley3D(jp))) <= 2


@pytest.mark.parametrize("spin", [0.0, 0.9])
def test_geodesics_and_rk4_match_jax(pq, rng, spin):
    (jp, tp), (jq, tq) = pq
    js, ts = JScene(spin_a=spin), TScene(spin_a=spin)
    # torch.rsqrt vs XLA's rsqrt differ by an ulp; the |L|^2/r^5 chain
    # keeps it at the 1e-7 relative level (atol: the spin term cancels)
    for a, b in zip(tg.geodesic_acc(ts, tp, tq), jg.geodesic_acc(js, jp, jq)):
        np.testing.assert_allclose(_np(a), _np(b), rtol=1e-6, atol=1e-8)
    near = _vec(rng.standard_normal((3, N)) * 0.4)
    for a, b in zip(tg.geodesic_acc(ts, near[1], tq), jg.geodesic_acc(js, near[0], jq)):
        np.testing.assert_array_equal(_np(a)[_np(tv.length(near[1])) < 1.0], 0.0)
    np.testing.assert_allclose(_np(tg.redshift_factor(ts, tp, tq)),
                               _np(jg.redshift_factor(js, jp, jq)), rtol=1e-6, atol=1e-7)
    h = (np.abs(rng.standard_normal(N)) * 0.3).astype(np.float32)
    jout = ji.rk4_step(js, jp, jq, jnp.asarray(h))
    tout = ti.rk4_step(ts, tp, tq, torch.from_numpy(h))
    for a, b in zip(list(tout[0]) + list(tout[1]), list(jout[0]) + list(jout[1])):
        np.testing.assert_allclose(_np(a), _np(b), rtol=1e-6, atol=1e-6)
    jout = ji.euler_step(js, jp, jq, 0.1)
    tout = ti.euler_step(ts, tp, tq, 0.1)
    for a, b in zip(list(tout[0]) + list(tout[1]), list(jout[0]) + list(jout[1])):
        np.testing.assert_allclose(_np(a), _np(b), rtol=1e-6, atol=1e-6)


def _disk_points(rng):
    r = rng.uniform(5.0, 30.0, N)
    phi = rng.uniform(-np.pi, np.pi, N)
    y = rng.uniform(-2.0, 2.0, N)
    return _vec(np.stack([r * np.cos(phi), y, r * np.sin(phi)]))


@pytest.mark.parametrize("t", [0.0, 1.7, 12.3])
def test_densities_match_jax(rng, t):
    jp, tp = _disk_points(rng)
    js, ts = JScene(), TScene()
    tt = torch.tensor(t, dtype=torch.float32)
    # torch's and XLA's exp/pow/sin/cos differ in the last ulp; the streak
    # shaping ((x*2.8)^1.6 past a threshold) and the cloud domain warp
    # amplify that — the same band test_densities.py allows vs the oracle
    for tfn, jfn in ((td.accretion_density, jd.accretion_density),
                     (td.dust_cloud_density, jd.dust_cloud_density)):
        got, want = _np(tfn(ts, tp, tt)), _np(jfn(js, jp, jnp.float32(t)))
        np.testing.assert_allclose(got, want, rtol=5e-3, atol=2e-4)
        # the gates (exact zeros) agree exactly
        np.testing.assert_array_equal(got == 0.0, want == 0.0)
    r = rng.uniform(0.0, 40.0, N).astype(np.float32)
    np.testing.assert_allclose(_np(td.disk_temperature(ts, torch.from_numpy(r))),
                               _np(jd.disk_temperature(js, jnp.asarray(r))), rtol=1e-6)


@pytest.mark.parametrize("kw", [dict(), dict(disk_h_m=1.3, isco_radius=8.0),
                                dict(cloud_h_m=0.9, disk_out_m=30.0)])
def test_probe_bounds_equal_jax_floats(kw):
    assert td.disk_probe_bounds(TScene(**kw)) == jd.disk_probe_bounds(JScene(**kw))
    assert td.cloud_probe_bounds(TScene(**kw)) == jd.cloud_probe_bounds(JScene(**kw))


@pytest.mark.parametrize("lens", [0.0, 1.0])
def test_camera_and_rays_match_jax(lens):
    pose = ((-18.0, -5.0, -38.0), 18.0, 4.0)
    jc, tc = jcam.camera_state_from_pose(*pose), tcam.camera_state_from_pose(*pose)
    for name in ("pos", "forward", "right", "up"):
        np.testing.assert_array_equal(getattr(tc, name), np.asarray(getattr(jc, name)))
    je = JEffects(use_lens_distortion=lens)
    te = TEffects(use_lens_distortion=lens)
    jo, jdr, jux, juy = jcam.generate_rays(96, 54, jc, je)
    to, tdr, tux, tuy = tcam.generate_rays(96, 54, tc, te, "cpu")
    for a, b in zip(list(to) + [tux, tuy], list(jo) + [jux, juy]):
        np.testing.assert_array_equal(_np(a), _np(b))
    # normalize: XLA's rsqrt rewrite, a few ulp
    for a, b in zip(tdr, jdr):
        assert _ulp(_np(a), _np(b)) <= 4


def test_postfx_matches_jax(rng):
    shape = (48, 64)
    hdr = rng.uniform(0.0, 3.0, (3,) + shape).astype(np.float32)
    uv = rng.uniform(0.0, 1.0, (2,) + shape).astype(np.float32)
    jh, th = _vec(hdr.reshape(3, -1))
    jh = jv.Vec3(*(c.reshape(shape) for c in jh))
    th = tv.Vec3(*(c.reshape(shape) for c in th))
    jux, juy = jnp.asarray(uv[0]), jnp.asarray(uv[1])
    tux, tuy = torch.from_numpy(uv[0]), torch.from_numpy(uv[1])
    for a, b in zip(tpost.apply_lens_distortion(tux, tuy, 0.15),
                    jpost.apply_lens_distortion(jux, juy, jnp.float32(0.15))):
        np.testing.assert_array_equal(_np(a), _np(b))
    for jeff, teff in ((JEffects(), TEffects()),
                       (JEffects(use_vignette=0.0, use_bloom=0.0),
                        TEffects(use_vignette=0.0, use_bloom=0.0))):
        jl = jpost.apply_effects_and_tonemap(jh, jux, juy, jeff, 0.8)
        tl = tpost.apply_effects_and_tonemap(th, tux, tuy, teff, 0.8)
        # exp differs by an ulp between torch and XLA
        for a, b in zip(tl, jl):
            np.testing.assert_allclose(_np(a), _np(b), rtol=0, atol=2e-7)
        jframe = np.asarray(jpost.pack_rgba8(jl))
        tframe = tpost.pack_rgba8(tl).numpy()
        assert tframe.dtype == np.uint8 and tframe.shape == shape + (4,)
        assert np.abs(tframe.astype(int) - jframe.astype(int)).max() <= 1
        np.testing.assert_array_equal(
            tpost.word_to_rgba8(tpost.pack_rgba8_word(tl)).numpy(), tframe)
    down_j = jpost.downsample_box(jh, 2)
    down_t = tpost.downsample_box(th, 2)
    for a, b in zip(down_t, down_j):
        np.testing.assert_allclose(_np(a), _np(b), rtol=1e-6)
    assert tpost.downsample_box(th, 1) is th
    # truncating cast, as the reference's C cast
    one = torch.tensor([0.999, 1.0 / 255.0 * 3.999, 2.0, -1.0])
    assert tpost.pack_rgba8(tv.Vec3(one, one, one))[:, 0].tolist() == [254, 3, 255, 0]
