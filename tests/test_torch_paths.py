"""PyTorch port: camera paths, controllers and the fixed-step clock against
the JAX package's (relativisticraytracer_tpu.paths; reference:
src/camera_paths.cpp, src/main.cpp:127-220).

Both modules are host float32 NumPy with the same operations, so every
comparison with JAX is bitwise."""

import dataclasses

import numpy as np
import pytest

from relativisticraytracer_tpu import paths as jpaths
from relativisticraytracer_tpu_torch.paths import (
    CameraController,
    CameraPath,
    Keyframe,
    PathController,
    PathManager,
    catmull_rom,
    default_paths,
    fixed_step_dt,
    init_default_paths,
    interpolate_path,
    lerp_angle,
)
from tests.oracle import numpy_ref as oracle


def _same_state(a, b):
    for name in ("pos", "forward", "right", "up"):
        np.testing.assert_array_equal(np.asarray(getattr(a, name)), np.asarray(getattr(b, name)))


def test_catmull_rom_bitwise_jax_and_oracle(rng):
    for _ in range(32):
        pts = (rng.random((4, 3), dtype=np.float32) - 0.5) * 80.0
        t = float(rng.random())
        got = catmull_rom(pts[0], pts[1], pts[2], pts[3], t)
        np.testing.assert_array_equal(got, jpaths.catmull_rom(*pts, t))
        np.testing.assert_allclose(got, oracle.catmull_rom(*pts, t), atol=1e-5)
        assert got.dtype == np.float32


def test_catmull_rom_endpoints():
    p = np.array([[0, 0, 0], [1, 2, 3], [4, 5, 6], [7, 8, 9]], dtype=np.float32)
    np.testing.assert_allclose(catmull_rom(*p, 0.0), p[1], atol=1e-6)
    np.testing.assert_allclose(catmull_rom(*p, 1.0), p[2], atol=1e-6)


def test_lerp_angle_bitwise_jax_and_oracle(rng):
    cases = [(0, 90, 0.5), (350, 10, 0.5), (-450, -90, 0.25), (10, 350, 0.5),
             (-196, 20, 0.9), (180, -180, 0.3)]
    for a, b, t in cases:
        assert lerp_angle(a, b, t) == jpaths.lerp_angle(a, b, t)
        assert abs(lerp_angle(a, b, t) - oracle.lerp_angle(a, b, t)) < 1e-4
    for _ in range(64):
        a, b = (rng.random(2) - 0.5) * 1000.0
        t = float(rng.random())
        assert lerp_angle(a, b, t) == jpaths.lerp_angle(a, b, t)


def test_lerp_angle_shortest_arc():
    # 350 -> 10 goes +20 degrees through 0, not -340.
    assert abs(lerp_angle(350.0, 10.0, 0.5) - 360.0) < 1e-5


def test_default_paths_verbatim():
    paths = default_paths()
    assert [p.name for p in paths] == [
        "Gargantua Fly-By", "Event Horizon Focus", "Horizon Skimmer",
    ]
    k = paths[0].keyframes[2]
    assert (k.time, k.pos, k.yaw, k.pitch) == (12.0, (35.0, 0.8, 10.0), -106.0, -1.2)
    assert [dataclasses.asdict(p) for p in paths] == \
        [dataclasses.asdict(p) for p in jpaths.default_paths()]


def test_interpolate_path_clamps_ends():
    path = default_paths()[0]
    pos, yaw, pitch = interpolate_path(path, -5.0)
    np.testing.assert_array_equal(pos, np.float32(path.keyframes[0].pos))
    assert (yaw, pitch) == (path.keyframes[0].yaw, path.keyframes[0].pitch)
    pos, yaw, pitch = interpolate_path(path, 999.0)
    np.testing.assert_array_equal(pos, np.float32(path.keyframes[-1].pos))
    with pytest.raises(ValueError, match="empty"):
        interpolate_path(CameraPath("none", []), 1.0)


def test_interpolate_path_hits_keyframes():
    path = default_paths()[0]
    for k in path.keyframes:
        pos, yaw, pitch = interpolate_path(path, k.time)
        np.testing.assert_allclose(pos, k.pos, atol=1e-4)
        assert abs(yaw - k.yaw) < 1e-4
        assert abs(pitch - k.pitch) < 1e-4


@pytest.mark.parametrize("index", [0, 1, 2])
def test_interpolate_path_bitwise_jax(index):
    """Every animation frame's pose (t = k / fps over the whole path and
    past its ends) and the camera basis built from it: bitwise JAX's."""
    from relativisticraytracer_tpu.render.camera import camera_state_from_pose as jpose
    from relativisticraytracer_tpu_torch.render.camera import camera_state_from_pose as tpose

    path, jpath = default_paths()[index], jpaths.default_paths()[index]
    for k in range(-3, int(path.keyframes[-1].time * 24) + 5, 7):
        t = k / 24.0
        pos, yaw, pitch = interpolate_path(path, t)
        jpos, jyaw, jpitch = jpaths.interpolate_path(jpath, t)
        np.testing.assert_array_equal(pos, jpos)
        assert (yaw, pitch) == (jyaw, jpitch)
        _same_state(tpose(pos, yaw, pitch), jpose(jpos, jyaw, jpitch))


def test_path_controller_clock_and_cycling():
    mgr = PathManager()
    init_default_paths(mgr)
    ctl = PathController(manager=mgr)
    jctl = jpaths.PathController(manager=jpaths.init_default_paths(jpaths.PathManager()))
    for c in (ctl, jctl):
        c.start()
        c.update(0.5)
        c.update(0.25)
    assert ctl.active and abs(ctl.path_time - 0.75) < 1e-9
    _same_state(ctl.interpolated_state(), jctl.interpolated_state())
    ctl.stop()
    ctl.update(1.0)
    assert abs(ctl.path_time - 0.75) < 1e-9  # frozen while inactive
    for _ in range(3):
        ctl.next_path()
    assert ctl.current_path_index == 0  # wraps mod 3
    # no path registered: the fallback camera
    empty = PathController(manager=PathManager())
    empty.next_path()
    _same_state(empty.interpolated_state(), CameraController().state())


def test_fixed_step_clock():
    for recording, wall in ((True, 0.123), (False, 0.123), (True, 5.0)):
        assert fixed_step_dt(recording, wall) == jpaths.fixed_step_dt(recording, wall)
    assert fixed_step_dt(True, 0.123) == 1.0 / 24
    assert fixed_step_dt(True, 0.1, fps=30) == 1.0 / 30
    assert fixed_step_dt(False, 0.123) == 0.123


def test_camera_controller_movement_quirks_bitwise_jax():
    cam, jcam = CameraController(), jpaths.CameraController()
    y0 = float(cam.pos[1])
    cam.move("space")  # reference: SPACE moves DOWN (main.cpp:351-353)
    assert float(cam.pos[1]) == y0 - np.float32(0.3)
    cam.move("shift")  # SHIFT moves UP (main.cpp:354-356)
    assert abs(float(cam.pos[1]) - y0) < 1e-6
    cam.look(10.0, 0.0)  # cursor right (+dx) increases yaw (main.cpp:316-323)
    assert cam.yaw == 1.0
    cam.look(0.0, -1e6)
    assert cam.pitch == -89.0  # clamped
    cam, steps = CameraController(), []
    for key in ("w", "w", "d", "space", "a", "shift", "s", "look", "w", "q"):
        for c in (cam, jcam):
            if key == "look":
                c.look(37.0, -12.5)
            else:
                c.move(key)
        np.testing.assert_array_equal(cam.pos, jcam.pos)
        steps.append(cam.pos.copy())
    assert (cam.yaw, cam.pitch) == (jcam.yaw, jcam.pitch)
    _same_state(cam.state(), jcam.state())
    assert len({tuple(p) for p in steps}) > 5  # the keys moved it


def test_custom_path_registration():
    mgr = PathManager()
    mgr.register_path(CameraPath("test", [Keyframe(0.0, (0, 0, -50), 0.0, 0.0),
                                          Keyframe(2.0, (0, 0, -40), 10.0, 0.0)]))
    assert mgr.get_path(0).name == "test"
    assert mgr.get_path(1) is None and mgr.get_path(-1) is None
    pos, yaw, _ = interpolate_path(mgr.get_path(0), 1.0)
    assert abs(yaw - 5.0) < 1e-5
    assert PathManager.instance() is PathManager.instance()
