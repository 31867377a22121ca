"""PyTorch port: IO and host runtime — frame sink, video recorder, PNG
frame sequences, the animation job and the headless session — against the
JAX package's (tests/test_io_runtime.py; reference: ScreenRecorder
main.cpp:29-124, main loop main.cpp:482-539).

Everything runs on the CPU (`device="cpu"`: the kernels' plain versions)
at 16x12 with 24 steps. Frames a job writes are byte for byte the port's
`Renderer.render_np` frames; against the JAX job's frames each is within
RMSE < 1e-3 (torch's and XLA's exp/pow/sin/cos differ in the last ulp,
tests/test_torch_inline_frames.py). Strings (ffmpeg command, sidecar) and
state files are equal to JAX's."""

import json
import os
import pathlib
import shlex
import types

import numpy as np
import pytest
import torch

from relativisticraytracer_tpu import config as jcfg
from relativisticraytracer_tpu.io import image as jimage
from relativisticraytracer_tpu.io import video as jvideo
from relativisticraytracer_tpu.paths import default_paths as jdefault_paths
from relativisticraytracer_tpu.render import pipeline as jpipeline
from relativisticraytracer_tpu.render import postfx as jpostfx
from relativisticraytracer_tpu.render.skybox import procedural_starfield as jstarfield
from relativisticraytracer_tpu.runtime import app as japp
from relativisticraytracer_tpu_torch.config import RenderSettings, SceneConfig
from relativisticraytracer_tpu_torch.io.image import (
    FrameSequenceWriter,
    decode_png,
    load_image_rgba,
    load_skybox,
    png_info,
    save_png,
)
from relativisticraytracer_tpu_torch.io.video import (
    SegmentedRecorder,
    VideoRecorder,
    ffmpeg_command,
    timestamped_filename,
)
from relativisticraytracer_tpu_torch.paths import default_paths, interpolate_path
from relativisticraytracer_tpu_torch.render.camera import camera_state_from_pose
from relativisticraytracer_tpu_torch.render.pipeline import Renderer
from relativisticraytracer_tpu_torch.render.postfx import yuv420_from_rgba8
from relativisticraytracer_tpu_torch.runtime.app import RECORDING_FPS, AnimationJob, Session
from relativisticraytracer_tpu_torch.runtime.framesink import FrameSink, _load_library

torch.set_num_threads(2)

W, H, STEPS = 16, 12, 24
FRAME_BYTES = W * H * 4
SKY = jstarfield(16, 32)  # one host array for both packages


@pytest.fixture
def no_ffmpeg(monkeypatch):
    monkeypatch.setattr("relativisticraytracer_tpu_torch.io.video.ffmpeg_available",
                        lambda: False)


def _tiny_renderer(width=W, height=H):
    return Renderer(SceneConfig(max_steps=STEPS),
                    RenderSettings(width=width, height=height, max_steps=STEPS, chunk=8),
                    skybox_rgba=SKY, device="cpu")


def _job_frames(n, fps=2, renderer=None, path_index=0):
    """The frames a job at `fps` writes, from Renderer.render_np at the
    job's poses and times (t = (k + 1) / fps)."""
    r = renderer or _tiny_renderer()
    path = default_paths()[path_index]
    out = []
    for k in range(n):
        t = (k + 1) / fps
        out.append(r.render_np(camera_state_from_pose(*interpolate_path(path, t)), None, t))
    return out


def test_native_library_builds_and_loads():
    assert _load_library() is not None, "native framesink failed to build/load"


@pytest.mark.parametrize("force_python", [False, True])
def test_framesink_file_roundtrip(tmp_path, force_python):
    out = tmp_path / "frames.rgba"
    frame_bytes = 16 * 8 * 4
    sink = FrameSink(str(out), frame_bytes, mode="file", queue_frames=4,
                     force_python=force_python)
    assert sink.native == (not force_python)
    frames = [bytes([i] * frame_bytes) for i in range(10)]
    for f in frames:
        sink.submit(f)
    assert sink.close() == 10
    assert out.read_bytes() == b"".join(frames)  # order preserved, nothing dropped


def test_framesink_pipe_roundtrip(tmp_path):
    out = tmp_path / "piped.bin"
    sink = FrameSink(f"cat > {out}", 64, mode="pipe", queue_frames=2)
    for i in range(5):
        sink.submit(bytes([i]) * 64)
    assert sink.close() == 5
    assert len(out.read_bytes()) == 5 * 64


def test_framesink_rejects_wrong_size(tmp_path):
    sink = FrameSink(str(tmp_path / "x.bin"), 64, mode="file")
    with pytest.raises(ValueError):
        sink.submit(b"short")
    sink.close()
    with pytest.raises(ValueError, match="append"):
        FrameSink("cat", 64, mode="pipe", append=True)


def test_ffmpeg_command_equals_jax():
    for args in ((1000, 700, 24, "out.mp4"), (64, 64, 24, "a b$.mp4"),
                 (4, 2, 30, "a $(hostname) \"b\".mp4"), (1920, 1080, 24, "x.mp4", "yuv420p")):
        assert ffmpeg_command(*args) == jvideo.ffmpeg_command(*args)
    cmd = ffmpeg_command(1000, 700, 24, "out.mp4")
    for part in ["-f rawvideo", "-pix_fmt rgba", "-s 1000x700", "-r 24", "-c:v libx264",
                 "-preset fast", "-crf 18", "-pix_fmt yuv420p"]:
        assert part in cmd
    assert cmd.endswith(" out.mp4") and "vflip" not in cmd


def test_timestamped_filename_shape():
    name = timestamped_filename()
    assert name.startswith("recording_") and name.endswith(".mp4")
    assert len(name) == len("recording_20260101_120000.mp4")


@pytest.mark.parametrize("pix_fmt", ["rgba", "yuv420p"])
def test_video_recorder_raw_fallback_sidecar_equals_jax(tmp_path, monkeypatch, pix_fmt):
    """The raw dump and its sidecar (with the encode command) are the JAX
    recorder's, string for string."""
    for mod in ("relativisticraytracer_tpu_torch.io.video", "relativisticraytracer_tpu.io.video"):
        monkeypatch.setattr(f"{mod}.ffmpeg_available", lambda: False)
    frame = np.arange(8 * 4 * 4, dtype=np.uint8).reshape(4, 8, 4)
    if pix_fmt == "yuv420p":
        frame = frame.reshape(-1)[:8 * 4 * 3 // 2]
    sides = []
    for name, cls in (("port", VideoRecorder), ("jax", jvideo.VideoRecorder)):
        (tmp_path / name).mkdir()
        monkeypatch.chdir(tmp_path / name)
        rec = cls(8, 4, out_path="clip.mp4", pix_fmt=pix_fmt)
        path = rec.start()
        rec.capture(frame)
        rec.capture(frame)
        assert rec.stop() == 2
        assert pathlib.Path(path).read_bytes() == frame.tobytes() * 2
        sides.append(pathlib.Path(path).with_suffix(".json").read_text())
    assert sides[0] == sides[1]
    assert "libx264" in json.loads(sides[0])["encode_with"]


def test_sidecar_encode_command_quotes_hostile_paths(tmp_path, no_ffmpeg):
    hostile = tmp_path / 'rec $1 "x".mp4'
    rec = VideoRecorder(8, 4, out_path=str(hostile))
    path = rec.start()
    rec.capture(np.zeros((4, 8, 4), dtype=np.uint8))
    rec.stop()
    cmd = json.loads(pathlib.Path(path).with_suffix(".json").read_text())["encode_with"]
    words = shlex.split(cmd)
    assert words[words.index("-i") + 1] == path
    assert words[-1] == str(hostile)
    assert '"' + path + '"' not in cmd


def test_animation_job_runs_and_resumes(tmp_path, no_ffmpeg):
    r = _tiny_renderer()
    job = AnimationJob(path=default_paths()[0], renderer=r, fps=2, duration=3.0,
                       out_path=str(tmp_path / "anim.rgba"), checkpoint_every=2)
    stats = job.run()
    assert stats["frames"] == 6 and stats["frames_written"] == 6 and stats["resumed_at"] == 0
    raw = pathlib.Path(stats["out_path"])
    full = raw.read_bytes()
    assert full == b"".join(f.tobytes() for f in _job_frames(6, renderer=r))
    # interrupted: the checkpoint says 4 frames done, a partial 5th on disk
    ck = pathlib.Path(stats["out_path"] + ".ckpt.json")
    ck.write_text(json.dumps({"next_frame": 4, "out_path": stats["out_path"]}))
    raw.write_bytes(full[: 4 * FRAME_BYTES + 100])
    stats2 = job.run(resume=True)
    assert (stats2["resumed_at"], stats2["frames"]) == (4, 2)
    assert not ck.exists()
    assert raw.read_bytes() == full


def test_job_frames_match_jax_job(tmp_path, monkeypatch):
    """The same job through both packages: the port's file is its
    render_np frames byte for byte, and each frame is within RMSE < 1e-3 of
    the JAX job's (torch's and XLA's transcendentals differ in the last
    ulp)."""
    for mod in ("relativisticraytracer_tpu_torch.io.video", "relativisticraytracer_tpu.io.video"):
        monkeypatch.setattr(f"{mod}.ffmpeg_available", lambda: False)
    port = AnimationJob(path=default_paths()[0], renderer=_tiny_renderer(), fps=2,
                        duration=2.0, out_path=str(tmp_path / "port.rgba")).run()
    jr = jpipeline.Renderer(jcfg.SceneConfig(max_steps=STEPS),
                            jcfg.RenderSettings(width=W, height=H, max_steps=STEPS, chunk=8),
                            skybox_rgba=SKY)
    jax_stats = japp.AnimationJob(path=jdefault_paths()[0], renderer=jr, fps=2, duration=2.0,
                                  out_path=str(tmp_path / "jax.rgba")).run()
    a = np.frombuffer(pathlib.Path(port["out_path"]).read_bytes(), np.uint8).reshape(4, H, W, 4)
    b = np.frombuffer(pathlib.Path(jax_stats["out_path"]).read_bytes(),
                      np.uint8).reshape(4, H, W, 4)
    np.testing.assert_array_equal(a, np.stack(_job_frames(4)))
    d = a[..., :3].astype(np.float64) - b[..., :3]
    rmse = np.sqrt(np.mean((d / 255.0) ** 2, axis=(1, 2, 3)))
    print(f"port vs JAX job frames: RMSE per frame {rmse.tolist()}, max |d| {np.abs(d).max()}")
    assert rmse.max() < 1e-3


def test_session_controls(tmp_path, monkeypatch, no_ffmpeg):
    monkeypatch.chdir(tmp_path)
    s = Session(renderer=_tiny_renderer())
    assert s.tick(0.016).shape == (H, W, 4)
    assert s.effects.use_bloom == 1.0
    s.handle_key("b")
    assert s.effects.use_bloom == 0.0
    s.handle_key("p")
    assert s.paths.active
    s.handle_key("n")
    assert s.paths.current_path_index == 1
    s.handle_key("r")
    assert s.recorder.is_recording
    t0 = s.sim_time
    s.tick(12345.0)  # wall dt ignored while recording
    assert abs(s.sim_time - (t0 + 1.0 / 24)) < 1e-9
    s.handle_key("r")
    assert not s.recorder.is_recording
    y0 = float(s.camera.pos[1])
    s.handle_key("space")  # movement quirk: space moves down
    assert float(s.camera.pos[1]) < y0
    s.handle_key("escape")
    assert s.quit_requested
    assert "Relativistic Ray Tracer" in s.status()
    s.close()


def test_session_builds_its_renderer_on_the_device(no_ffmpeg):
    s = Session(scene=SceneConfig(max_steps=4), settings=RenderSettings(width=8, height=4),
                skybox_rgba=SKY, device="cpu")
    assert s.renderer.device == torch.device("cpu")
    assert s.tick(0.01).shape == (4, 8, 4)
    s.close()


def test_load_skybox_fallback_and_png(tmp_path):
    sky = load_skybox(None, fallback_shape=(16, 32), device="cpu")
    assert sky.shape == (16, 32, 4) and sky.dtype == np.uint8
    p = tmp_path / "sub" / "img.png"
    save_png(str(p), sky)
    from PIL import Image

    with Image.open(p) as im:  # the port's PNG, decoded by Pillow
        np.testing.assert_array_equal(np.asarray(im.convert("RGBA")), sky)
    np.testing.assert_array_equal(load_image_rgba(str(p)), sky)
    np.testing.assert_array_equal(decode_png(p), sky)
    np.testing.assert_array_equal(load_skybox(str(p)), sky)
    # an unreadable file falls back to the starfield, as the reference does
    (tmp_path / "bad.png").write_bytes(b"not a png")
    np.testing.assert_array_equal(
        load_skybox(str(tmp_path / "bad.png"), fallback_shape=(16, 32), device="cpu"), sky)


@pytest.mark.parametrize("mode", ["RGBA", "RGB", "L"])
def test_stdlib_png_decoder_reads_pillow_pngs(tmp_path, rng, mode):
    """Pillow writes adaptive filters (Sub, Up, Average, Paeth); the
    standard-library decoder undoes each and expands to RGBA as Pillow's
    convert does."""
    from PIL import Image

    img = rng.integers(0, 256, (13, 21, 4), dtype=np.uint8)
    img[:, :10] = img[:, :1]  # smooth runs make Pillow choose several filters
    im = Image.fromarray(img).convert(mode)
    im.save(tmp_path / "p.png", optimize=True)
    with Image.open(tmp_path / "p.png") as back:
        want = np.asarray(back.convert("RGBA"))
    np.testing.assert_array_equal(decode_png(tmp_path / "p.png"), want)


def test_png_writer_takes_rgb_and_rgba_only(tmp_path):
    rgb = np.arange(5 * 7 * 3, dtype=np.uint8).reshape(5, 7, 3)
    save_png(str(tmp_path / "rgb.png"), rgb)
    back = decode_png(tmp_path / "rgb.png")
    np.testing.assert_array_equal(back[..., :3], rgb)
    assert (back[..., 3] == 255).all()
    with pytest.raises(ValueError, match="3 or 4"):
        save_png(str(tmp_path / "gray.png"), rgb[..., 0])
    (tmp_path / "la.png").write_bytes(gray_alpha_png())
    with pytest.raises(ValueError, match="gray/RGB/RGBA"):
        decode_png(tmp_path / "la.png")


def gray_alpha_png() -> bytes:
    """A 1x1 gray+alpha PNG, which the standard-library decoder refuses."""
    import struct
    import zlib

    def chunk(kind, data):
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))

    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", 1, 1, 8, 4, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(b"\x00\x10\x20")) + chunk(b"IEND", b""))


def test_second_recording_gets_fresh_filename(tmp_path, monkeypatch, no_ffmpeg):
    monkeypatch.chdir(tmp_path)
    monkeypatch.delenv("RRT_RECORDING_DIR", raising=False)
    import time as _t

    rec = VideoRecorder(4, 2)
    first = rec.start()
    rec.capture(np.zeros((2, 4, 4), dtype=np.uint8))
    rec.stop()
    _t.sleep(1.1)  # timestamped filename has 1s resolution
    second = rec.start()
    rec.stop()
    assert first != second
    assert pathlib.Path(first).exists() and pathlib.Path(second).exists()


def test_python_sink_survives_dead_consumer():
    import time as _t

    sink = FrameSink("head -c 64 > /dev/null", 64, mode="pipe", queue_frames=2,
                     force_python=True)
    _t.sleep(0.3)
    with pytest.raises(IOError):
        for _ in range(5000):
            sink.submit(b"x" * 64)
        sink.close()


def test_resume_clamps_to_frames_on_disk(tmp_path, no_ffmpeg):
    job = AnimationJob(path=default_paths()[0], renderer=_tiny_renderer(), fps=2,
                       duration=3.0, out_path=str(tmp_path / "anim.rgba"), checkpoint_every=2)
    stats = job.run()
    raw = pathlib.Path(stats["out_path"])
    full = raw.read_bytes()
    raw.write_bytes(full[: 2 * FRAME_BYTES])  # disk has 2, the checkpoint claims 4
    pathlib.Path(stats["out_path"] + ".ckpt.json").write_text(
        json.dumps({"next_frame": 4, "out_path": stats["out_path"]}))
    assert job.run(resume=True)["resumed_at"] == 2
    assert raw.read_bytes() == full


FAKE_FFMPEG = r'''#!/usr/bin/env python3
"""Fake ffmpeg: rawvideo mode copies stdin to the output file; concat
mode concatenates the listed files. Output = last argument."""
import sys

args = sys.argv[1:]
out = args[-1]
if "concat" in args:
    lst = args[args.index("-i") + 1]
    data = b""
    for line in open(lst):
        line = line.strip()
        if line.startswith("file "):
            path = line[5:].strip().strip("'\"")
            data += open(path, "rb").read()
else:
    data = sys.stdin.buffer.read()
open(out, "wb").write(data)
'''


@pytest.fixture
def fake_ffmpeg(tmp_path, monkeypatch):
    """An `ffmpeg` shim on PATH that writes raw bytes, so the MP4 sink's
    plumbing (pipe sink, segments, concat) runs without an encoder."""
    bindir = tmp_path / "bin"
    bindir.mkdir()
    exe = bindir / "ffmpeg"
    exe.write_text(FAKE_FFMPEG)
    exe.chmod(0o755)
    monkeypatch.setenv("PATH", f"{bindir}:{os.environ['PATH']}")
    import shutil

    assert shutil.which("ffmpeg") == str(exe)
    return exe


def test_animation_mp4_segments_and_resume(tmp_path, monkeypatch, fake_ffmpeg):
    monkeypatch.chdir(tmp_path)
    r = _tiny_renderer()
    path = default_paths()[0]
    full = AnimationJob(path=path, renderer=r, fps=2, duration=3.0,
                        out_path=str(tmp_path / "full.mp4"), checkpoint_every=2).run()
    assert full["frames"] == 6 and full["frames_written"] == 6
    want = (tmp_path / "full.mp4").read_bytes()
    assert want == b"".join(f.tobytes() for f in _job_frames(6, renderer=r))
    assert not (tmp_path / "full.mp4.ckpt.json").exists()
    assert not (tmp_path / "full.mp4.segs").exists()

    out2 = str(tmp_path / "resumed.mp4")
    job = AnimationJob(path=path, renderer=r, fps=2, duration=3.0, out_path=out2,
                       checkpoint_every=2)

    class Boom(RuntimeError):
        pass

    def bomb(k, n, ms):
        if k >= 3:
            raise Boom()

    with pytest.raises(Boom):
        job.run(progress=bomb)
    ck = json.loads((tmp_path / "resumed.mp4.ckpt.json").read_text())
    assert 2 <= ck["next_frame"] < 6
    stats = job.run(resume=True)
    assert stats["resumed_at"] == ck["next_frame"]
    assert (tmp_path / "resumed.mp4").read_bytes() == want
    assert not (tmp_path / "resumed.mp4.ckpt.json").exists()


def test_animation_mp4_resume_geometry_mismatch(tmp_path, monkeypatch, fake_ffmpeg):
    monkeypatch.chdir(tmp_path)
    out = str(tmp_path / "a.mp4")
    seg = SegmentedRecorder(16, 12, 2, out_path=out, segment_frames=2)
    seg.capture(np.zeros((12, 16, 4), np.uint8))
    seg.capture(np.zeros((12, 16, 4), np.uint8))
    seg.abort()
    with pytest.raises(ValueError, match="geometry"):
        SegmentedRecorder(32, 24, 2, out_path=out, segment_frames=2).resume()
    with pytest.raises(ValueError, match="segment_frames"):
        SegmentedRecorder(16, 12, 2, out_path=out, segment_frames=0)


def test_animation_frame_parallel_devices(tmp_path, no_ffmpeg):
    """Frames dealt round-robin to a list of devices (here the CPU twice)
    make the identical byte stream."""
    r = _tiny_renderer()
    single = AnimationJob(path=default_paths()[0], renderer=r, fps=2, duration=2.0,
                          out_path=str(tmp_path / "one.rgba")).run()
    multi = AnimationJob(path=default_paths()[0], renderer=r, fps=2, duration=2.0,
                         out_path=str(tmp_path / "many.rgba")).run(
        devices=["cpu", torch.device("cpu")])
    assert multi["devices"] == 2
    assert single["frames_written"] == multi["frames_written"] == 4
    assert (pathlib.Path(single["out_path"]).read_bytes()
            == pathlib.Path(multi["out_path"]).read_bytes())


def test_session_state_roundtrip(tmp_path, no_ffmpeg):
    s1 = Session(renderer=_tiny_renderer())
    s1.handle_key("b")
    s1.handle_key("d")
    s1.mouse(30.0, -5.0)
    s1.handle_key("p")
    s1.handle_key("n")
    s1.tick(1.0 / 24.0)
    state_file = tmp_path / "session.json"
    s1.save_state(str(state_file))
    s1.close()
    s2 = Session(renderer=_tiny_renderer())
    assert s2.load_state(str(state_file))
    assert s2.effects.use_bloom == 0.0
    np.testing.assert_array_equal(s2.camera.pos, s1.camera.pos)
    assert (s2.camera.yaw, s2.camera.pitch, s2.sim_time) == \
        (s1.camera.yaw, s1.camera.pitch, s1.sim_time)
    assert s2.paths.active and s2.paths.current_path_index == 1
    assert s2.paths.path_time == s1.paths.path_time
    assert s2.tick(1.0 / 24.0).shape == (H, W, 4)
    s2.close()


def test_session_state_json_interchangeable_with_jax(tmp_path, monkeypatch):
    """A state file written by either package's Session loads in the
    other's with the same pose, clock, path and effects."""
    for mod in ("relativisticraytracer_tpu_torch.io.video", "relativisticraytracer_tpu.io.video"):
        monkeypatch.setattr(f"{mod}.ffmpeg_available", lambda: False)
    # the JAX session never renders here: a stand-in with its settings
    jax_renderer = types.SimpleNamespace(settings=jcfg.RenderSettings(width=W, height=H))
    port = Session(renderer=_tiny_renderer())
    jax_session = japp.Session(renderer=jax_renderer)
    for key in ("c", "w", "w", "a", "p", "n", "n"):
        port.handle_key(key)
        jax_session.handle_key(key)
    port.mouse(12.0, 3.5)
    jax_session.mouse(12.0, 3.5)
    port.sim_time = jax_session.sim_time = 3.25
    port.paths.path_time = jax_session.paths.path_time = 1.5
    port.save_state(str(tmp_path / "port.json"))
    jax_session.save_state(str(tmp_path / "jax.json"))
    assert json.loads((tmp_path / "port.json").read_text()) == \
        json.loads((tmp_path / "jax.json").read_text())
    fresh_port = Session(renderer=_tiny_renderer())
    fresh_jax = japp.Session(renderer=jax_renderer)
    assert fresh_port.load_state(str(tmp_path / "jax.json"))
    assert fresh_jax.load_state(str(tmp_path / "port.json"))
    np.testing.assert_array_equal(fresh_port.camera.pos, np.asarray(fresh_jax.camera.pos))
    assert fresh_port.effects.use_chromatic_aberration == 1.0
    assert float(fresh_jax.effects.use_chromatic_aberration) == 1.0
    assert (fresh_port.paths.current_path_index, fresh_port.sim_time) == (2, 3.25)
    for s in (port, fresh_port):
        s.close()


def test_load_state_tolerates_corrupt_file(tmp_path, no_ffmpeg):
    bad = tmp_path / "session.json"
    bad.write_text('{"pos": [0.0, 10.')  # killed mid-write
    s = Session(renderer=_tiny_renderer())
    default_pos = s.camera.pos.copy()
    assert s.load_state(str(bad)) is False
    np.testing.assert_array_equal(s.camera.pos, default_pos)
    bad.write_text('{"pos": [0, 1, 2], "yaw": 0, "pitch": 0, "sim_time": 0,'
                   ' "path_index": 0, "path_active": false, "path_time": 0,'
                   ' "effects": {"no_such_field": 1}}')
    assert s.load_state(str(bad)) is False
    good = tmp_path / "ok.json"
    s.save_state(str(good))
    assert not list(tmp_path.glob("*.tmp"))
    assert s.load_state(str(good)) is True
    s.close()


def test_animation_png_sequence_and_resume(tmp_path):
    r = _tiny_renderer()
    out_dir = tmp_path / "frames"
    job = AnimationJob(path=default_paths()[0], renderer=r, fps=2, duration=3.0,
                       out_path=str(out_dir) + "/")
    assert job.run()["frames_written"] == 6
    files = sorted(out_dir.glob("frame_*.png"))
    assert [f.name for f in files] == [f"frame_{k:05d}.png" for k in range(6)]
    for f, want in zip(files, _job_frames(6, renderer=r)):
        np.testing.assert_array_equal(decode_png(f), want)
        assert png_info(f) == ((W, H), {"rrt_fps": "2"})
    orig = [f.read_bytes() for f in files]
    for f in files[3:]:
        f.unlink()
    assert job.run(resume=True)["resumed_at"] == 3
    assert [f.read_bytes() for f in sorted(out_dir.glob("frame_*.png"))] == orig
    assert job.run(resume=False)["resumed_at"] == 0
    assert [f.read_bytes() for f in sorted(out_dir.glob("frame_*.png"))] == orig


def test_png_sequences_interchangeable_with_jax(tmp_path):
    """Either package's FrameSequenceWriter resumes the other's directory,
    and refuses it at another size or fps."""
    frame = np.zeros((12, 16, 4), np.uint8)
    for writer, reader in ((FrameSequenceWriter, jimage.FrameSequenceWriter),
                           (jimage.FrameSequenceWriter, FrameSequenceWriter)):
        d = tmp_path / writer.__module__.replace(".", "_")
        a = writer(str(d), 16, 12, fps=24)
        a.resume()
        a.capture(frame)
        a.capture(frame)
        assert reader(str(d), 16, 12, fps=24).resume() == 2
        with pytest.raises(ValueError, match="16x12"):
            reader(str(d), 8, 6, fps=24).resume()
        with pytest.raises(ValueError, match="24 fps"):
            reader(str(d), 16, 12, fps=48).resume()
        np.testing.assert_array_equal(load_image_rgba(str(d / "frame_00001.png")), frame)


def test_motion_adaptive_preview_quality(no_ffmpeg):
    quality, motion = _tiny_renderer(), _tiny_renderer()
    used = []
    for tag, r in (("quality", quality), ("motion", motion)):
        real = r.render_np
        r.render_np = (lambda real, tag: lambda *a, **k: (
            used.append(tag), real(*a, **k))[1])(real, tag)
    s = Session(renderer=quality, motion_renderer=motion, motion_hold_s=0.2)
    s.tick(0.01)
    s.handle_key("w")
    s.tick(0.01)
    s.mouse(5.0, 0.0)
    s.tick(0.01)
    import time as _t

    _t.sleep(0.25)
    s.tick(0.01)
    s.handle_key("w")
    s.handle_key("r")
    s.tick(0.01)
    s.handle_key("r")
    s.close()
    assert used == ["quality", "motion", "motion", "quality", "quality"]


def test_raw_resume_refuses_missing_sidecar(tmp_path, no_ffmpeg):
    out = tmp_path / "rec.rgba"
    rec = VideoRecorder(16, 12, fps=2, out_path=str(out))
    rec.start()
    rec.capture(np.zeros((12, 16, 4), dtype=np.uint8))
    rec.stop()
    out.with_suffix(".json").unlink()
    with pytest.raises(ValueError, match="sidecar"):
        VideoRecorder(16, 12, fps=2, out_path=str(out)).start(append_frames=1)


def test_record_toggle_race_with_render_loop(no_ffmpeg):
    import threading as _th

    s = Session(renderer=_tiny_renderer())
    stop = _th.Event()

    def toggler():
        while not stop.is_set():
            s.handle_key("r")

    t = _th.Thread(target=toggler, daemon=True)
    t.start()
    try:
        for _ in range(30):
            s.tick(0.01)
    finally:
        stop.set()
        t.join(5.0)
    assert not t.is_alive()
    s.close()


def test_sink_surfaces_nonzero_pipe_exit():
    sink = FrameSink("cat > /dev/null; exit 3", 64, mode="pipe", queue_frames=2)
    sink.submit(b"x" * 64)
    with pytest.raises(IOError):
        sink.close()


def test_motion_race_defers_capture_to_next_tick(no_ffmpeg):
    quality, motion = _tiny_renderer(), _tiny_renderer()
    used = []
    s = Session(renderer=quality, motion_renderer=motion, motion_hold_s=5.0)

    def tag(r, name, race=False):
        real = r.render_np

        def wrapped(*a, **k):
            used.append(name)
            if race and not s.recorder.is_recording:
                s.handle_key("r")  # recording toggles on MID-render
            return real(*a, **k)

        r.render_np = wrapped

    tag(quality, "quality")
    tag(motion, "motion", race=True)
    captured = []
    real_capture = s.recorder.capture
    s.recorder.capture = lambda f: (captured.append(list(used)), real_capture(f))[1]
    s.handle_key("w")
    t0 = s.sim_time
    s.tick(0.01)
    assert used == ["motion"] and captured == []
    assert abs(s.sim_time - (t0 + 0.01)) < 1e-9
    t1 = s.sim_time
    s.tick(0.01)
    s.close()
    assert used == ["motion", "quality"] and len(captured) == 1
    assert abs(s.sim_time - (t1 + 1.0 / RECORDING_FPS)) < 1e-9


def test_png_resume_geometry_mismatch(tmp_path):
    a = FrameSequenceWriter(str(tmp_path), 16, 12)
    a.resume()
    a.capture(np.zeros((12, 16, 4), dtype=np.uint8))
    with pytest.raises(ValueError, match="16x12"):
        FrameSequenceWriter(str(tmp_path), 8, 6).resume()
    with pytest.raises(ValueError, match="bad frame"):
        a.capture(np.zeros((6, 8, 4), dtype=np.uint8))


def test_png_resume_drops_stale_tail(tmp_path):
    r = _tiny_renderer()
    out_dir = tmp_path / "frames"
    AnimationJob(path=default_paths()[0], renderer=r, fps=2, duration=3.0,
                 out_path=str(out_dir) + "/").run()
    assert len(list(out_dir.glob("frame_*.png"))) == 6
    stats = AnimationJob(path=default_paths()[0], renderer=r, fps=2, duration=2.0,
                         out_path=str(out_dir) + "/").run(resume=True)
    assert sorted(f.name for f in out_dir.glob("frame_*.png")) == \
        [f"frame_{k:05d}.png" for k in range(4)]
    assert stats["frames_written"] == 4


def test_yuv420_converter_matches_oracle_and_jax():
    """RGBA -> YUV420 (BT.601 limited, 2x2 box chroma) against an
    independent NumPy transcription (within 1 level: float32 against
    float64 at a .5 boundary) and the JAX package's (equal expected, 1
    level allowed for the 2x2 sum's order)."""
    rng = np.random.RandomState(7)
    h, w = 12, 16
    frame = rng.randint(0, 256, (h, w, 4), dtype=np.uint8)
    got = yuv420_from_rgba8(torch.as_tensor(frame)).numpy()
    assert got.shape == (h * w * 3 // 2,) and got.dtype == np.uint8
    jax_got = np.asarray(jpostfx.yuv420_from_rgba8(frame))
    assert int(np.abs(got.astype(int) - jax_got).max()) <= 1
    print(f"yuv420 port vs JAX: {int((got != jax_got).sum())} of {got.size} bytes differ")

    rgb = frame[..., :3].astype(np.float64) / 255.0
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    yp = 0.299 * r + 0.587 * g + 0.114 * b
    y8 = np.clip(16.0 + 219.0 * yp + 0.5, 0, 255).astype(np.uint8)
    u = 128.0 + 112.0 * (b - yp) / 0.886
    v = 128.0 + 112.0 * (r - yp) / 0.701

    def sub(c):
        c = c.reshape(h // 2, 2, w // 2, 2).mean(axis=(1, 3))
        return np.clip(c + 0.5, 0, 255).astype(np.uint8)

    want = np.concatenate([y8.reshape(-1), sub(u).reshape(-1), sub(v).reshape(-1)])
    assert int(np.abs(got.astype(int) - want.astype(int)).max()) <= 1
    with pytest.raises(ValueError, match="even"):
        yuv420_from_rgba8(torch.zeros((11, 16, 4), dtype=torch.uint8))


def test_grain_hash_matches_jax(rng):
    from relativisticraytracer_tpu_torch.render.postfx import grain_hash

    px, py = (rng.random((2, 64)) * 512).astype(np.float32)
    got = grain_hash(torch.as_tensor(px), torch.as_tensor(py)).numpy()
    np.testing.assert_allclose(got, np.asarray(jpostfx.grain_hash(px, py)), atol=2e-3)


def test_animation_yuv_transfer_raw_sink(tmp_path, no_ffmpeg):
    r = _tiny_renderer()
    job = AnimationJob(path=default_paths()[0], renderer=r, fps=2, duration=3.0,
                       out_path=str(tmp_path / "anim.mp4"), checkpoint_every=2,
                       transfer="yuv420p")
    stats = job.run()
    raw = pathlib.Path(stats["out_path"])
    assert raw.suffix == ".yuv"
    fb = W * H * 3 // 2
    assert raw.read_bytes() == b"".join(
        yuv420_from_rgba8(torch.as_tensor(f)).numpy().tobytes()
        for f in _job_frames(6, renderer=r))
    side = json.loads(raw.with_suffix(".json").read_text())
    assert side["pix_fmt"] == "yuv420p"
    assert "-pix_fmt yuv420p" in side["encode_with"].split("-c:v")[0]
    ck = pathlib.Path(stats["out_path"] + ".ckpt.json")
    ck.write_text(json.dumps({"next_frame": 4, "out_path": stats["out_path"]}))
    raw.write_bytes(raw.read_bytes()[: 4 * fb + 7])
    assert job.run(resume=True)["resumed_at"] == 4
    assert raw.stat().st_size == 6 * fb
    job_png = AnimationJob(path=default_paths()[0], renderer=r, fps=2, duration=1.0,
                           out_path=str(tmp_path / "seq") + "/", transfer="yuv420p")
    with pytest.raises(ValueError, match="rgba"):
        job_png.run()


def test_png_fresh_run_overwrites_different_resolution(tmp_path):
    out_dir = tmp_path / "frames"
    AnimationJob(path=default_paths()[0], renderer=_tiny_renderer(), fps=2, duration=1.0,
                 out_path=str(out_dir) + "/").run()
    assert len(list(out_dir.glob("frame_*.png"))) == 2
    stats = AnimationJob(path=default_paths()[0], renderer=_tiny_renderer(8, 6), fps=2,
                         duration=1.0, out_path=str(out_dir) + "/").run(resume=False)
    assert stats["frames_written"] == 2
    assert png_info(out_dir / "frame_00000.png")[0] == (8, 6)


def test_mp4_resume_shorter_duration_drops_tail_segments(tmp_path, monkeypatch, fake_ffmpeg):
    monkeypatch.chdir(tmp_path)
    r = _tiny_renderer()
    path = default_paths()[0]
    ref = AnimationJob(path=path, renderer=r, fps=2, duration=2.0,
                       out_path=str(tmp_path / "ref.mp4"), checkpoint_every=2).run()
    assert ref["frames_written"] == 4
    want = (tmp_path / "ref.mp4").read_bytes()
    out = str(tmp_path / "clip.mp4")

    class Boom(RuntimeError):
        pass

    def bomb(k, n, ms):
        if k >= 5:
            raise Boom()

    with pytest.raises(Boom):
        AnimationJob(path=path, renderer=r, fps=2, duration=3.0, out_path=out,
                     checkpoint_every=2).run(progress=bomb)
    stats = AnimationJob(path=path, renderer=r, fps=2, duration=2.0, out_path=out,
                         checkpoint_every=2).run(resume=True)
    assert stats["frames"] >= 0 and stats["frames_written"] == 4
    assert (tmp_path / "clip.mp4").read_bytes() == want
    assert len(want) == 4 * FRAME_BYTES


def test_raw_resume_shorter_duration_truncates(tmp_path, no_ffmpeg):
    r = _tiny_renderer()
    out = str(tmp_path / "clip.rgba")
    AnimationJob(path=default_paths()[0], renderer=r, fps=2, duration=3.0, out_path=out,
                 checkpoint_every=2).run()
    assert (tmp_path / "clip.rgba").stat().st_size == 6 * FRAME_BYTES
    job2 = AnimationJob(path=default_paths()[0], renderer=r, fps=2, duration=2.0,
                        out_path=out, checkpoint_every=2)
    job2._checkpoint_path(out).write_text(json.dumps({"next_frame": 6, "out_path": out}))
    stats = job2.run(resume=True)
    assert stats["frames"] == 0 and stats["frames_written"] == 0
    assert (tmp_path / "clip.rgba").stat().st_size == 4 * FRAME_BYTES


def test_png_resume_fps_mismatch(tmp_path):
    a = FrameSequenceWriter(str(tmp_path), 16, 12, fps=24)
    a.resume()
    a.capture(np.zeros((12, 16, 4), dtype=np.uint8))
    with pytest.raises(ValueError, match="24 fps"):
        FrameSequenceWriter(str(tmp_path), 16, 12, fps=48).resume()
    assert FrameSequenceWriter(str(tmp_path), 16, 12, fps=24).resume() == 1
    # frames without the chunk (fps unknown) are accepted
    b = FrameSequenceWriter(str(tmp_path / "nofps"), 16, 12)
    b.resume()
    b.capture(np.zeros((12, 16, 4), dtype=np.uint8))
    assert FrameSequenceWriter(str(tmp_path / "nofps"), 16, 12, fps=30).resume() == 1


def test_ffmpeg_command_shell_quotes_out_path():
    cmd = ffmpeg_command(4, 2, 24, "a $(hostname) \"b\".mp4")
    assert "$(hostname)" in cmd
    assert "'a $(hostname) \"b\".mp4'" in cmd
