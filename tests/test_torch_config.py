"""PyTorch port: configuration, state carried across from the JAX package,
and the port's import hygiene.

The dataclasses must equal the JAX package's field for field (same names,
same defaults, same errors); interop must reproduce the port's own state
bit for bit from the JAX package's numpy/dict hand-over."""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from relativisticraytracer_tpu import config as jcfg
from relativisticraytracer_tpu.render import camera as jcam
from relativisticraytracer_tpu.render import skybox as jsky
from relativisticraytracer_tpu_torch import config as tcfg
from relativisticraytracer_tpu_torch import interop
from relativisticraytracer_tpu_torch.render import camera as tcam
from relativisticraytracer_tpu_torch.render import skybox as tsky

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
STARFIELD = ROOT / "tests" / "torch_data" / "starfield_64x128.npy"


def _fields(cls):
    return [(f.name, f.default) for f in dataclasses.fields(cls)]


@pytest.mark.parametrize("cls", ["SceneConfig", "RenderSettings"])
def test_dataclass_fields_match_jax(cls):
    assert _fields(getattr(tcfg, cls)) == _fields(getattr(jcfg, cls))


def test_scene_constants_and_helpers_match_jax():
    assert tcfg.PI == jcfg.PI == 3.1415926535
    for jscene, tscene in ((jcfg.SceneConfig(), tcfg.SceneConfig()),
                           (jcfg.KERR_SCENE, tcfg.KERR_SCENE),
                           (jcfg.SceneConfig(noise_octave_cap=2),
                            tcfg.SceneConfig(noise_octave_cap=2))):
        assert dataclasses.asdict(jscene) == dataclasses.asdict(tscene)
        assert jscene.m_unit == tscene.m_unit
        assert [jscene.octaves(n) for n in (1, 2, 5)] == \
            [tscene.octaves(n) for n in (1, 2, 5)]


def test_camera_effects_match_jax_as_float32():
    for jeff, teff in ((jcfg.CameraEffects(), tcfg.CameraEffects()),
                       (jcfg.effects_off(), tcfg.effects_off()),
                       (jcfg.CameraEffects(ca_amount=0.01, use_bloom=0.0),
                        tcfg.CameraEffects(ca_amount=0.01, use_bloom=0.0))):
        for f in dataclasses.fields(tcfg.CameraEffects):
            assert np.float32(getattr(teff, f.name)) == np.asarray(getattr(jeff, f.name))
    eff = tcfg.CameraEffects().replace(use_chromatic_aberration=1.0)
    assert eff.use_chromatic_aberration == 1.0 and eff.use_bloom == 1.0
    assert eff.ca_offset() == np.float32(0.005)
    assert tcfg.CameraEffects().ca_offset() == 0.0


@pytest.mark.parametrize("kw,match", [
    (dict(media_pass="Compact"), "media_pass"),
    (dict(media_slots=0), "media_slots"),
    (dict(sky_gather="window"), "sky_gather"),
])
def test_render_settings_errors_match_jax(kw, match):
    for cls in (jcfg.RenderSettings, tcfg.RenderSettings):
        with pytest.raises(ValueError, match=match):
            cls(**kw)


def test_octave_cap_error_and_max_steps_match_jax():
    for cls in (jcfg.SceneConfig, tcfg.SceneConfig):
        with pytest.raises(ValueError, match="noise_octave_cap"):
            cls(noise_octave_cap=0)
    scene = tcfg.SceneConfig(max_steps=8)
    assert tcfg.RenderSettings().resolved_max_steps(scene) == 8
    assert tcfg.RenderSettings(max_steps=16).resolved_max_steps(scene) == 16


def test_inline_media_pass_is_not_ported_yet():
    """media_pass="inline" is ported now: the renderer takes the fused
    inline march (ops/pallas_march.render_frame_pallas) and renders where it
    raised NotImplementedError before; an unknown pass is still refused."""
    from relativisticraytracer_tpu_torch.ops import pallas_march
    from relativisticraytracer_tpu_torch.render.pipeline import Renderer

    r = Renderer(tcfg.SceneConfig(max_steps=4),
                 tcfg.RenderSettings(width=8, height=4, media_pass="inline"),
                 device="cpu")
    assert r._fn is pallas_march.render_frame_pallas
    frame = r.render(tcam.default_camera())
    assert frame.shape == (4, 8, 4) and frame.dtype == torch.uint8
    with pytest.raises(ValueError, match="media_pass"):
        tcfg.RenderSettings(media_pass="fused")


def test_port_imports_no_jax():
    """Every module of the port, the graft entry included, and every
    import statement of the port's examples run without JAX: the card
    machine has none."""
    code = (
        "import ast, importlib, pathlib, pkgutil, sys\n"
        "import relativisticraytracer_tpu_torch as pkg\n"
        "for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "assert 'relativisticraytracer_tpu_torch.graft_entry' in sys.modules\n"
        "examples = sorted(pathlib.Path(pkg.__path__[0], 'examples').glob('*.py'))\n"
        "assert len(examples) == 6, examples\n"
        "for path in examples:\n"
        "    tree = ast.parse(path.read_text())\n"
        "    imports = [n for n in ast.walk(tree) if isinstance(n, (ast.Import, ast.ImportFrom))]\n"
        "    exec(compile(ast.Module(body=imports, type_ignores=[]), str(path), 'exec'), {})\n"
        "assert 'jax' not in sys.modules, sorted(k for k in sys.modules if 'jax' in k)\n"
        "assert not any(k.startswith('relativisticraytracer_tpu.') or\n"
        "               k == 'relativisticraytracer_tpu' for k in sys.modules)\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT, env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_interop_scene_camera_effects_round_trip():
    jscene = jcfg.SceneConfig(spin_a=0.9, mass_pos=(0.0, 1.0, 0.0),
                              noise_octave_cap=3)
    assert interop.scene_from_dict(dataclasses.asdict(jscene)) == \
        tcfg.SceneConfig(spin_a=0.9, mass_pos=(0.0, 1.0, 0.0), noise_octave_cap=3)

    pose = ((1.0, 2.0, -30.0), 12.5, -7.0)
    jc = jcam.camera_state_from_pose(*pose)
    tc = interop.camera_from_arrays(*(np.asarray(a) for a in
                                      (jc.pos, jc.forward, jc.right, jc.up)))
    want = tcam.camera_state_from_pose(*pose)
    for name in ("pos", "forward", "right", "up"):
        np.testing.assert_array_equal(getattr(tc, name), getattr(want, name))

    jeff = jcfg.CameraEffects(use_chromatic_aberration=1.0, ca_amount=0.01)
    teff = interop.effects_from_dict(
        {f.name: np.asarray(getattr(jeff, f.name))
         for f in dataclasses.fields(jcfg.CameraEffects)})
    assert teff == tcfg.CameraEffects(use_chromatic_aberration=1.0, ca_amount=0.01)


def test_interop_skybox_planes_bitwise():
    rgba = np.load(STARFIELD)
    js = jsky.skybox_from_array(rgba, fast_table=True)
    ts = interop.skybox_from_planes(*(np.asarray(p) for p in js), device="cpu")
    own = tsky.skybox_from_array(rgba, "cpu")
    assert ts.shape == own.shape == js.shape
    for a, b in zip(ts, own):
        assert a.dtype == torch.int32
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="uint32"):
        interop.skybox_from_planes(*(np.zeros((3, 4), np.int64) for _ in range(3)),
                                   device="cpu")


def test_committed_starfield_is_the_jax_starfield():
    """tests/torch_data/starfield_64x128.npy lets the card render the goldens
    without JAX: it must be JAX's procedural_starfield(64, 128) byte for
    byte. The port's own starfield calls torch's sin/cos, whose last-ulp
    differences from XLA's may flip threshold pixels: report how many."""
    want = jsky.procedural_starfield(64, 128)
    got = np.load(STARFIELD)
    assert got.dtype == np.uint8 and got.shape == (64, 128, 4)
    np.testing.assert_array_equal(got, want)
    own = tsky.procedural_starfield(64, 128, device="cpu")
    flipped = int(np.any(own != want, axis=-1).sum())
    print(f"port starfield: {flipped} of {64 * 128} pixels differ from JAX's")
    assert flipped <= 0.01 * 64 * 128
