"""The port's package root and graft entry (relativisticraytracer_tpu_torch
/__init__.py, graft_entry.py) against the JAX package's
(relativisticraytracer_tpu/__init__.py, the repo root's __graft_entry__.py).

entry()'s frame is held against JAX's entry() jitted on the CPU with the
same inputs carried over through interop.py, at the RMSE < 1e-3 gate of
bench.py:84-89; the dry run's 1080p shard grid must be bitwise the
untiled frame after reassembly."""

import dataclasses
import importlib.util
import pathlib

import jax
import numpy as np
import pytest
import torch

import relativisticraytracer_tpu as jpkg
import relativisticraytracer_tpu_torch as tpkg
from relativisticraytracer_tpu_torch import graft_entry, interop
from relativisticraytracer_tpu_torch.config import CameraEffects, RenderSettings, SceneConfig
from relativisticraytracer_tpu_torch.render.camera import camera_state_from_pose
from relativisticraytracer_tpu_torch.render.pipeline import Renderer
from relativisticraytracer_tpu_torch.render.skybox import procedural_starfield

torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _jax_graft_entry():
    spec = importlib.util.spec_from_file_location("_jax_graft_entry", ROOT / "__graft_entry__.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _rmse(a, b):
    d = a[..., :3].astype(np.int64) - b[..., :3].astype(np.int64)
    return float(np.sqrt(np.mean((d / 255.0) ** 2)))


def test_package_root_exports_the_jax_root_api():
    """Fault F3: the port's root lacked the path API of the JAX root."""
    assert set(jpkg.__all__) <= set(tpkg.__all__)
    for name in tpkg.__all__:
        assert getattr(tpkg, name) is not None, name
    from relativisticraytracer_tpu_torch import paths

    for name in ("Keyframe", "CameraPath", "PathManager", "PathController",
                 "CameraController", "catmull_rom", "lerp_angle", "init_default_paths"):
        assert getattr(tpkg, name) is getattr(paths, name)


def test_entry_frame_matches_jax_entry():
    jfn, (jcam, jeff, jtime, jsky) = _jax_graft_entry().entry()
    want = np.asarray(jax.jit(jfn)(jcam, jeff, jtime, jsky))

    fn, (cam, eff, time, sky) = graft_entry.entry(device="cpu")
    assert float(time) == float(jtime) and eff == CameraEffects()
    assert sky.shape == jsky.shape == (128, 256)
    # the JAX inputs carried over: the starfield's threshold pixels may
    # differ by an ulp of sin/cos between the packages' own builds
    cam = interop.camera_from_arrays(*(np.asarray(a) for a in
                                       (jcam.pos, jcam.forward, jcam.right, jcam.up)))
    eff = interop.effects_from_dict({f.name: np.asarray(getattr(jeff, f.name))
                                     for f in dataclasses.fields(jeff)})
    sky = interop.skybox_from_planes(*(np.asarray(p) for p in jsky), device="cpu")
    got = fn(cam, eff, float(jtime), sky).numpy()
    assert got.shape == want.shape == (256, 256, 4) and got.dtype == np.uint8
    # measured: RMSE 1.25e-5, max 1 level (torch's and XLA's exp/pow/sin/cos
    # differ in the last ulp on the CPU)
    assert _rmse(got, want) < 1e-3


def test_dryrun_multichip_on_cpu_devices(capsys):
    out = graft_entry.dryrun_multichip(8, devices=["cpu"] * 8)
    printed = capsys.readouterr().out.splitlines()
    assert len(printed) == 3 and all("OK" in line for line in printed)
    assert all("1 distinct device(s)" in line for line in printed)
    assert out["frame"].shape == (32, 32, 4)
    assert out["job"]["frames_written"] == 4 and out["job"]["devices"] == 8
    # the 1080p grid, reassembled, is bitwise the untiled compact frame
    untiled = Renderer(SceneConfig(max_steps=8),
                       RenderSettings(width=1920, height=1080, max_steps=8),
                       skybox_rgba=procedural_starfield(64, 128, device="cpu"),
                       device="cpu").render_np(camera_state_from_pose(*graft_entry.POSE),
                                               CameraEffects(), 1.0)
    np.testing.assert_array_equal(out["frame_hd"], untiled)


def test_shard_devices_repeat_and_never_fall_back():
    assert graft_entry.shard_devices(3, ["cpu", "meta"]) == [torch.device("cpu"),
                                                             torch.device("meta"),
                                                             torch.device("cpu")]
    with pytest.raises(ValueError, match="empty"):
        graft_entry.shard_devices(2, [])
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: devices=None takes it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        graft_entry.dryrun_multichip(8)
