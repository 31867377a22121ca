"""Scene / render configuration (PyTorch port of relativisticraytracer_tpu.config).

`SceneConfig` mirrors the reference compile-time constants name for name
(reference: include/config.h:6-49); it is the pixel-parity contract and is
field-for-field the JAX package's dataclass.

`CameraEffects` is a plain dataclass of float scalars. Every value is kept
at float32 precision (stored as the Python float of the float32), because
the JAX package holds them as float32 arrays and the frame math combines
them in float32.

`RenderSettings` keeps every field of the JAX settings and the same
validation errors. The port has no `resolved_loop()` that probes the
machine: the renderer's explicit `device` decides the path (`cuda` launches
the hand-written kernels, `cpu` runs their plain PyTorch versions).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

# Window defaults (reference: include/config.h:7-9)
WINDOW_WIDTH = 1000
WINDOW_HEIGHT = 700
RECORDING_FPS = 24

PI = 3.1415926535  # reference: include/math_utils.h:7 (float32 literal)


@dataclasses.dataclass(frozen=True)
class SceneConfig:
    """Physics + scene constants (reference: include/config.h:11-48).

    All values are geometric units (1.0 = M, the black-hole mass) unless
    noted. Defaults reproduce the reference scene (Sagittarius A*).
    """

    # --- physical constants (SI), kept for unit conversions ---
    c_light: float = 299792458.0          # config.h:12
    g_constant: float = 6.67430e-11       # config.h:13
    solar_mass: float = 1.98847e30        # config.h:14

    # --- target object ---
    bh_mass_solar: float = 4.154e6        # config.h:17
    disk_temp_ref: float = 1.5e7          # [K] config.h:18

    # --- Kerr parameters ---
    spin_a: float = 0.0                   # config.h:21 (dimensionless, 0..1)
    spin_axis: Tuple[float, float, float] = (0.0, 1.0, 0.0)  # config.h:22

    # --- geometric units ---
    event_horizon: float = 2.0            # [M] Rs = 2M, config.h:29
    mass_pos: Tuple[float, float, float] = (0.0, 0.0, 0.0)   # config.h:30

    # --- disk tuning ---
    isco_radius: float = 10.0             # config.h:33
    disk_out_m: float = 25.0              # config.h:34
    disk_h_m: float = 0.8                 # config.h:35
    disk_luminosity: float = 6.0          # config.h:36
    disk_opacity: float = 0.4             # config.h:37
    exposure: float = 0.8                 # config.h:38

    # --- dust-cloud layer ---
    cloud_h_m: float = 0.5                # config.h:41
    cloud_out_m: float = 25.0             # config.h:42
    cloud_opacity: float = 0.3            # config.h:43
    cloud_luminosity: float = 0.4         # config.h:44

    # --- integration quality ---
    step_size_m: float = 0.3              # config.h:47
    max_steps: int = 2000                 # config.h:48

    # --- escape condition (reference: src/raymarcher.cu:120) ---
    escape_radius: float = 250.0

    # --- feature gates (fold entire subsystems out of the frame) ---
    enable_disk: bool = True
    enable_clouds: bool = True

    # --- quality knob: cap every fbm/ridge octave count in the media noise
    # stack (None = the reference's exact counts). ---
    noise_octave_cap: Optional[int] = None

    def __post_init__(self):
        # A cap of 0 would run every fbm/ridge loop for zero iterations —
        # the disk/cloud structure would silently vanish instead of erroring.
        if self.noise_octave_cap is not None and self.noise_octave_cap < 1:
            raise ValueError(
                f"noise_octave_cap must be >= 1 or None, got "
                f"{self.noise_octave_cap}"
            )

    def octaves(self, n: int) -> int:
        """Effective octave count for a reference count of `n`."""
        return n if self.noise_octave_cap is None else min(n, self.noise_octave_cap)

    @property
    def m_unit(self) -> float:
        """Mass in meters, M = G*Mass/c^2 (reference: config.h:26)."""
        return self.g_constant * (self.bh_mass_solar * self.solar_mass) / (
            self.c_light * self.c_light
        )


DEFAULT_SCENE = SceneConfig()

# Kerr a=0.9 variant used by the BASELINE config ladder.
KERR_SCENE = dataclasses.replace(DEFAULT_SCENE, spin_a=0.9)


def f32(x) -> float:
    """`x` rounded to float32, as a Python float."""
    return float(np.float32(x))


@dataclasses.dataclass
class CameraEffects:
    """Runtime-togglable post effects (reference: camera_settings.h:4-17).

    Flags are 0.0/1.0 floats, as in the JAX package; every field holds a
    float32-exact Python float."""

    use_bloom: float = None
    bloom_threshold: float = None
    bloom_intensity: float = None
    use_vignette: float = None
    vignette_intensity: float = None
    use_chromatic_aberration: float = None
    ca_amount: float = None
    use_lens_distortion: float = None
    distortion_amount: float = None

    def __post_init__(self):
        # Reference defaults (camera_settings.h:5-16).
        defaults = dict(
            use_bloom=1.0,
            bloom_threshold=0.8,
            bloom_intensity=0.5,
            use_vignette=1.0,
            vignette_intensity=0.4,
            use_chromatic_aberration=0.0,
            ca_amount=0.005,
            use_lens_distortion=1.0,
            distortion_amount=0.15,
        )
        for name, default in defaults.items():
            value = getattr(self, name)
            if value is None:
                value = default
            object.__setattr__(self, name, f32(value))

    def replace(self, **kwargs) -> "CameraEffects":
        return dataclasses.replace(self, **kwargs)

    def ca_offset(self) -> float:
        """Effective chromatic-aberration phi offset: 0.0 while the effect
        is off, so all three channels share the G coordinates
        (raymarcher.cu:131-145)."""
        return self.ca_amount if self.use_chromatic_aberration > 0.5 else 0.0


def effects_off() -> CameraEffects:
    """All post effects disabled (BASELINE configs 1-4 before the animation)."""
    return CameraEffects(
        use_bloom=0.0,
        use_vignette=0.0,
        use_chromatic_aberration=0.0,
        use_lens_distortion=0.0,
    )


@dataclasses.dataclass(frozen=True)
class RenderSettings:
    """Static, shape-affecting render quality knobs.

    Field for field the JAX package's settings. In the port `loop`,
    `chunk`, `media_capacity` and `sky_gather` are accepted and validated
    but select nothing: the renderer's device picks kernels or plain
    versions, the replay's compaction has dynamic shapes, and the sky is a
    direct per-pixel gather. `media_pass` picks the frame program:
    "compact" (record + replay) or "inline" (the fused march)."""

    width: int = WINDOW_WIDTH
    height: int = WINDOW_HEIGHT
    # Step-cap override. None (default) = use the scene's max_steps.
    max_steps: Optional[int] = None
    loop: str = "auto"
    chunk: int = 64
    # Supersampling AA factor: rays on an (s*H, s*W) grid, box-filtered
    # after tone mapping. 1 = reference behavior.
    supersample: int = 1
    media_pass: str = "compact"
    # Exactly-tracked media segments per ray on the compact path; later
    # crossings merge into the last slot (replayed with harmless gap steps).
    media_slots: int = 3
    # True: replay only the rays that recorded media, longest first.
    # False: replay every pixel in image order. Bitwise the same (I, T).
    media_sort: bool = True
    media_capacity: int = 1 << 17
    sky_gather: str = "windowed"

    def __post_init__(self):
        if self.media_pass not in ("compact", "inline"):
            raise ValueError(
                f"media_pass must be 'compact' or 'inline', got "
                f"{self.media_pass!r}"
            )
        if self.media_slots < 1:
            raise ValueError(
                f"media_slots must be >= 1, got {self.media_slots}"
            )
        if self.sky_gather not in ("rows", "windowed"):
            raise ValueError(
                f"sky_gather must be 'rows' or 'windowed', got "
                f"{self.sky_gather!r}"
            )

    def resolved_max_steps(self, scene: SceneConfig) -> int:
        """The march step cap: this override if set, else the scene's."""
        return self.max_steps if self.max_steps is not None else scene.max_steps
