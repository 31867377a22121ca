"""Keyframed camera paths + fly camera (port of relativisticraytracer_tpu.paths;
host-side, plain float32 NumPy, so bitwise the JAX package's module).

Reproduces the reference keyframe system exactly:
  * `catmull_rom` spline on position (reference: src/camera_paths.cpp:6-22),
  * `lerp_angle` shortest-arc interpolation (camera_paths.cpp:25-29),
  * endpoint clamping + segment search + neighbor indexing
    (reference: src/main.cpp:176-203),
  * the three built-in cinematic paths verbatim (camera_paths.cpp:31-73),
  * the fixed-step simulation clock used while recording
    (reference: src/main.cpp:511-513),
  * the WASD/Space/Shift fly camera (main.cpp:127-168, 308-357 — including
    the reference's inverted Space/Shift vertical movement).
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Sequence, Tuple

import numpy as np

from relativisticraytracer_tpu_torch.config import RECORDING_FPS
from relativisticraytracer_tpu_torch.render.camera import CameraState, camera_state_from_pose

Vec = Tuple[float, float, float]


@dataclasses.dataclass
class Keyframe:
    """(time, pos, yaw, pitch) — reference: camera_paths.h:8-13."""

    time: float
    pos: Vec
    yaw: float
    pitch: float


@dataclasses.dataclass
class CameraPath:
    """Named keyframe sequence — reference: camera_paths.h:15-18."""

    name: str
    keyframes: List[Keyframe]


def catmull_rom(p0, p1, p2, p3, t: float) -> np.ndarray:
    """Uniform Catmull-Rom on positions (reference: camera_paths.cpp:6-22)."""
    p0 = np.asarray(p0, dtype=np.float32)
    p1 = np.asarray(p1, dtype=np.float32)
    p2 = np.asarray(p2, dtype=np.float32)
    p3 = np.asarray(p3, dtype=np.float32)
    t = np.float32(t)
    t2 = t * t
    t3 = t2 * t
    return np.float32(0.5) * (
        (np.float32(2.0) * p1)
        + (-p0 + p2) * t
        + (np.float32(2.0) * p0 - np.float32(5.0) * p1 + np.float32(4.0) * p2 - p3) * t2
        + (-p0 + np.float32(3.0) * p1 - np.float32(3.0) * p2 + p3) * t3
    )


def lerp_angle(a: float, b: float, t: float) -> float:
    """Shortest-arc angle lerp in degrees (reference: camera_paths.cpp:25-29).
    Uses C fmodf semantics (sign-preserving)."""
    diff = math.fmod(b - a + 180.0, 360.0) - 180.0
    if diff < -180.0:
        diff += 360.0
    return float(a + diff * t)


class PathManager:
    """Path registry (reference: camera_paths.h:20-42). The reference uses a
    Meyers singleton; we keep `instance()` for familiarity but the class is
    a plain registry you can instantiate freely."""

    _instance: Optional["PathManager"] = None

    def __init__(self):
        self.paths: List[CameraPath] = []

    @classmethod
    def instance(cls) -> "PathManager":
        if cls._instance is None:
            cls._instance = cls()
        return cls._instance

    def register_path(self, path: CameraPath) -> None:
        self.paths.append(path)

    def get_paths(self) -> Sequence[CameraPath]:
        return self.paths

    def get_path(self, index: int) -> Optional[CameraPath]:
        if 0 <= index < len(self.paths):
            return self.paths[index]
        return None


def default_paths() -> List[CameraPath]:
    """The three built-in cinematic paths, keyframes verbatim
    (reference: camera_paths.cpp:31-73)."""
    gargantua = CameraPath(
        "Gargantua Fly-By",
        [
            Keyframe(0.0, (0.0, 15.0, -80.0), 0.0, -10.6),
            Keyframe(6.0, (15.0, 3.0, -30.0), -26.6, -5.1),
            Keyframe(12.0, (35.0, 0.8, 10.0), -106.0, -1.2),
            Keyframe(18.0, (5.0, 1.5, 50.0), -174.3, -1.7),
            Keyframe(25.0, (-20.0, 12.0, 70.0), -196.0, -9.3),
        ],
    )
    orbit = CameraPath(
        "Event Horizon Focus",
        [
            Keyframe(0.0, (40.0, 2.0, 0.0), -90.0, 0.0),
            Keyframe(8.0, (0.0, 5.0, 40.0), -180.0, -5.0),
            Keyframe(16.0, (-40.0, 2.0, 0.0), -270.0, 0.0),
            Keyframe(24.0, (0.0, -5.0, -40.0), -360.0, 5.0),
            Keyframe(32.0, (40.0, 2.0, 0.0), -450.0, 0.0),
        ],
    )
    skimmer = CameraPath(
        "Horizon Skimmer",
        [
            Keyframe(0.0, (0.0, 10.0, -60.0), 0.0, -9.5),
            Keyframe(8.0, (15.0, 2.0, -15.0), -45.0, -4.7),
            Keyframe(14.0, (4.2, 0.6, 4.2), -90.0, -5.7),
            Keyframe(20.0, (-20.0, 8.0, -20.0), -225.0, -20.0),
            Keyframe(26.0, (-20.0, 8.0, -20.0), 20.0, -10.0),
            Keyframe(29.0, (-30.0, 2.0, -30.0), 45.0, -2.7),
        ],
    )
    return [gargantua, orbit, skimmer]


def init_default_paths(manager: Optional[PathManager] = None) -> PathManager:
    """Register the built-in paths (reference: camera_paths.cpp:31)."""
    manager = manager or PathManager.instance()
    for path in default_paths():
        manager.register_path(path)
    return manager


def interpolate_path(path: CameraPath, t: float) -> Tuple[np.ndarray, float, float]:
    """(pos, yaw, pitch) at path time t, with endpoint clamping, segment
    search, and CR neighbor indices i-1..i+2 clamped to the ends
    (reference: src/main.cpp:176-201)."""
    keys = path.keyframes
    if not keys:
        raise ValueError("empty path")
    if t <= keys[0].time:
        k = keys[0]
        return np.asarray(k.pos, dtype=np.float32), k.yaw, k.pitch
    if t >= keys[-1].time:
        k = keys[-1]
        return np.asarray(k.pos, dtype=np.float32), k.yaw, k.pitch

    for i in range(len(keys) - 1):
        if keys[i].time <= t <= keys[i + 1].time:
            factor = (t - keys[i].time) / (keys[i + 1].time - keys[i].time)
            i0 = max(0, i - 1)
            i1 = i
            i2 = i + 1
            i3 = min(len(keys) - 1, i + 2)
            pos = catmull_rom(
                keys[i0].pos, keys[i1].pos, keys[i2].pos, keys[i3].pos, factor
            )
            yaw = lerp_angle(keys[i1].yaw, keys[i2].yaw, factor)
            pitch = lerp_angle(keys[i1].pitch, keys[i2].pitch, factor)
            return pos, yaw, pitch
    # Unreachable given the clamps above.
    k = keys[-1]
    return np.asarray(k.pos, dtype=np.float32), k.yaw, k.pitch


@dataclasses.dataclass
class CameraController:
    """Free-fly camera (reference: src/main.cpp:127-168).

    Defaults: pos (0, 10, -60), yaw 0, pitch -10, speed 0.3,
    mouse sensitivity 0.1."""

    pos: np.ndarray = dataclasses.field(
        default_factory=lambda: np.array([0.0, 10.0, -60.0], dtype=np.float32)
    )
    yaw: float = 0.0
    pitch: float = -10.0
    move_speed: float = 0.3
    mouse_sensitivity: float = 0.1

    def state(self) -> CameraState:
        return camera_state_from_pose(self.pos, self.yaw, self.pitch)

    def move(self, key: str) -> None:
        """One movement tick (reference: processInput, main.cpp:329-357).
        NB: the reference maps SPACE to -y and SHIFT to +y (main.cpp:351-356);
        we preserve that quirk."""
        cs = self.state()
        fwd = np.asarray(cs.forward)
        right = np.asarray(cs.right)
        s = np.float32(self.move_speed)
        if key == "w":
            self.pos = self.pos + fwd * s
        elif key == "s":
            self.pos = self.pos - fwd * s
        elif key == "a":
            self.pos = self.pos - right * s
        elif key == "d":
            self.pos = self.pos + right * s
        elif key == "space":
            self.pos = self.pos - np.array([0, s, 0], dtype=np.float32)
        elif key == "shift":
            self.pos = self.pos + np.array([0, s, 0], dtype=np.float32)

    def look(self, dx: float, dy: float) -> None:
        """Mouse look with +/-89 deg pitch clamp. dx, dy are raw cursor
        deltas (newPos - lastPos). The reference computes offsets as
        lastPos - newPos and then SUBTRACTS them (main.cpp:316-324), which
        nets to yaw/pitch INCREASING with the raw delta."""
        self.yaw += dx * self.mouse_sensitivity
        self.pitch += dy * self.mouse_sensitivity
        self.pitch = min(89.0, max(-89.0, self.pitch))


@dataclasses.dataclass
class PathController:
    """Path playback clock (reference: src/main.cpp:171-220)."""

    manager: PathManager = dataclasses.field(default_factory=PathManager.instance)
    current_path_index: int = 0
    active: bool = False
    path_time: float = 0.0

    def start(self) -> None:
        self.active = True
        self.path_time = 0.0

    def stop(self) -> None:
        self.active = False

    def update(self, dt: float) -> None:
        if self.active:
            self.path_time += dt

    def next_path(self) -> None:
        n = len(self.manager.get_paths())
        if n:
            self.current_path_index = (self.current_path_index + 1) % n

    def interpolated_state(self, fallback: Optional[CameraController] = None) -> CameraState:
        path = self.manager.get_path(self.current_path_index)
        if path is None or not path.keyframes:
            return (fallback or CameraController()).state()
        pos, yaw, pitch = interpolate_path(path, self.path_time)
        return camera_state_from_pose(pos, yaw, pitch)


def fixed_step_dt(recording: bool, wall_dt: float, fps: int = RECORDING_FPS) -> float:
    """While recording, the sim clock is pinned to 1/FPS
    (reference: src/main.cpp:511-513)."""
    return 1.0 / fps if recording else wall_dt
