"""PyTorch port: the sky background (ops/pallas_sky.py) against the JAX
package's windowed sky (`sky_background_windowed`, interpret mode) and
`gather_sky_coords`, on the same numpy-seeded directions.

Contract (pallas_sky.py:328-337): unmasked pixels are bitwise
gather_sky_coords; masked pixels (captured rays, T = 0) read 0 in the port.
Bitwise means against gather_sky_coords evaluated op by op
(`jax.disable_jit`): jitted, XLA's CPU backend contracts the bilinear
lerps into FMAs, which moves the 0..255 intermediate by up to an ulp —
at most 6e-8 after the 1/255 scale, the tolerance against the jitted
windowed path.
The cases mirror tests/test_sky_window.py:74-185 — smooth and random
directions, masked pixels and an all-masked sub-tile, chromatic aberration,
a sky narrower than the JAX window, the U-wrap seam and the V-clamp poles."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from relativisticraytracer_tpu.config import CameraEffects as JEffects
from relativisticraytracer_tpu.config import effects_off as j_effects_off
from relativisticraytracer_tpu.core.vecmath import Vec3 as JVec3
from relativisticraytracer_tpu.ops.pallas_sky import sky_background_windowed as j_windowed
from relativisticraytracer_tpu.render import skybox as jsky
from relativisticraytracer_tpu_torch import interop
from relativisticraytracer_tpu_torch.config import CameraEffects as TEffects
from relativisticraytracer_tpu_torch.config import effects_off as t_effects_off
from relativisticraytracer_tpu_torch.core.vecmath import Vec3 as TVec3
from relativisticraytracer_tpu_torch.ops.pallas_sky import sky_background_windowed
from relativisticraytracer_tpu_torch.render import skybox as tsky

torch.set_num_threads(2)

N_ROWS = 32  # 4 JAX sub-tiles of 8 lane rows


def _skies(h=64, w=128):
    rgba = jsky.procedural_starfield(h, w)
    js = jsky.skybox_from_array(rgba, fast_table=True)
    return js, interop.skybox_from_planes(*(np.asarray(p) for p in js), device="cpu")


def _dirs(kind, rng):
    if kind == "smooth":
        yy, xx = np.meshgrid(np.linspace(-0.4, 0.4, N_ROWS),
                             np.linspace(-0.7, 0.7, 128), indexing="ij")
        v = np.stack([xx, yy, np.ones_like(xx)])
    elif kind == "random":
        v = rng.standard_normal((3, N_ROWS, 128))
    elif kind == "seam":  # phi = atan2(z, x) = +-pi: the U-wrap seam
        z = np.linspace(-1e-3, 1e-3, N_ROWS * 128).reshape(N_ROWS, 128)
        v = np.stack([-np.ones_like(z), rng.uniform(-0.5, 0.5, z.shape), z])
    elif kind == "poles":  # |y| -> 1: the V-clamp rows
        y = np.where(rng.random((N_ROWS, 128)) < 0.5, 1.0, -1.0)
        v = np.stack([rng.uniform(-1e-3, 1e-3, y.shape), y,
                      rng.uniform(-1e-3, 1e-3, y.shape)])
    v = (v / np.linalg.norm(v, axis=0, keepdims=True)).astype(np.float32)
    return JVec3(*(jnp.asarray(c) for c in v)), TVec3(*(torch.from_numpy(c.copy()) for c in v))


def _jax_coords(jd, sky_shape, ca):
    coords = jsky.sky_coords(jd, jnp.float32(ca), *sky_shape)
    stacked = [torch.from_numpy(np.stack([np.asarray(c[j]) for c in coords]))
               for j in range(3)]
    return coords, stacked


def _check(js, ts, jd, td, masked, jeff, teff, ca=0.0):
    coords, (idx, fx, fy) = _jax_coords(jd, js.shape, ca)
    # the port's own coordinates: the same polynomial atan2 and quad
    # addressing; arcsin's sqrt(1 - y^2) may differ by an ulp, which can
    # only move fy by an ulp and never the quad index here
    tcoords = tsky.sky_coords(td, teff.ca_offset(), *ts.shape)
    for (ti, tfx, tfy), (ji, jfx, jfy) in zip(tcoords, coords):
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(tfx.numpy(), np.asarray(jfx))
        np.testing.assert_allclose(tfy.numpy(), np.asarray(jfy), rtol=0, atol=3e-5)
    with jax.disable_jit():
        want = jsky.gather_sky_coords(js, coords, jeff)
    want_w = j_windowed(js, coords, jeff, jnp.asarray(masked), interpret=True)
    got = sky_background_windowed(ts, idx, fx, fy, teff, torch.from_numpy(masked))
    ok = ~masked
    for g, w, ww in zip(got, want, want_w):
        g, w, ww = g.numpy(), np.asarray(w), np.asarray(ww)
        np.testing.assert_array_equal(g[ok], w[ok])
        np.testing.assert_allclose(g[ok], ww[ok], rtol=0, atol=6e-8)
        assert (g[masked] == 0.0).all()


@pytest.mark.parametrize("kind", ["smooth", "random", "seam", "poles"])
def test_sky_matches_jax_windowed_and_gather(rng, kind):
    js, ts = _skies()
    jd, td = _dirs(kind, rng)
    masked = np.zeros((N_ROWS, 128), bool)
    _check(js, ts, jd, td, masked, j_effects_off(), t_effects_off())


def test_sky_masked_pixels_and_all_masked_subtile(rng):
    js, ts = _skies()
    jd, td = _dirs("smooth", rng)
    masked = rng.random((N_ROWS, 128)) < 0.3
    masked[:8] = True
    _check(js, ts, jd, td, masked, j_effects_off(), t_effects_off())


@pytest.mark.parametrize("q4", [True, False])
def test_sky_chromatic_aberration(rng, q4):
    js, ts = _skies()
    if not q4:  # no interleaved table: per-channel gathers, same bits
        ts = ts._replace(q4=None)
    jd, td = _dirs("random", rng)
    masked = rng.random((N_ROWS, 128)) < 0.1
    _check(js, ts, jd, td, masked,
           JEffects(use_chromatic_aberration=1.0, ca_amount=0.01),
           TEffects(use_chromatic_aberration=1.0, ca_amount=0.01), ca=0.01)


def test_sky_small_and_large_skies(rng):
    """A sky narrower than the JAX window (which JAX clamps) and one wider
    than it both hold the contract."""
    for h, w in ((16, 64), (128, 512)):
        js, ts = _skies(h, w)
        jd, td = _dirs("random", rng)
        masked = rng.random((N_ROWS, 128)) < 0.2
        _check(js, ts, jd, td, masked, j_effects_off(), t_effects_off())


def test_skybox_quad_planes_match_jax():
    rgba = jsky.procedural_starfield(32, 64)
    js = jsky.skybox_from_array(rgba, fast_table=True)
    ts = tsky.skybox_from_array(rgba, "cpu")
    for a, b in zip(ts, js):
        np.testing.assert_array_equal(a.numpy().view(np.uint32), np.asarray(b))
    assert ts.shape == js.shape == (32, 64)
    with pytest.raises(ValueError, match="uint8"):
        tsky.skybox_from_array(rgba.astype(np.int32), "cpu")
    # sample_sky_fast on a direction field agrees with the JAX sampler
    rng = np.random.default_rng(3)
    jd, td = _dirs("random", rng)
    for eff_j, eff_t in ((j_effects_off(), t_effects_off()),
                         (JEffects(use_chromatic_aberration=1.0, ca_amount=0.01),
                          TEffects(use_chromatic_aberration=1.0, ca_amount=0.01))):
        with jax.disable_jit():
            want = jsky.sample_sky(js, jd, eff_j)
        got = tsky.sample_sky_fast(ts, td, eff_t)
        for g, w in zip(got, want):
            # the port's arcsin may differ from XLA's by an ulp, moving fy
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-5)
