"""PyTorch port: the live preview (MJPEG over HTTP, terminal), profiling
helpers and the command-line launcher, against the JAX package's
(tests/test_preview.py, tests/test_profiling_cli.py).

Everything runs on the CPU (`--device cpu` / `device="cpu"`) at tiny sizes;
the CLI tests pass a small `--skybox` PNG so no 1024x2048 starfield is
built. The CLI's `paths` text and its argument errors are JAX's, word for
word. The last test checks that a machine without Pillow loses nothing
but the JPEG preview."""

import http.client
import io
import json
import os
import pathlib
import subprocess
import sys
import time

import pytest
import torch

from relativisticraytracer_tpu.__main__ import main as jax_cli_main
from relativisticraytracer_tpu.render.skybox import procedural_starfield as jstarfield
from relativisticraytracer_tpu_torch.__main__ import _positive_int
from relativisticraytracer_tpu_torch.__main__ import main as cli_main
from relativisticraytracer_tpu_torch.config import RenderSettings, SceneConfig, effects_off
from relativisticraytracer_tpu_torch.io.image import load_image_rgba, save_png
from relativisticraytracer_tpu_torch.render.camera import (
    camera_state_from_pose,
    generate_rays,
)
from relativisticraytracer_tpu_torch.render.march import march
from relativisticraytracer_tpu_torch.render.pipeline import Renderer
from relativisticraytracer_tpu_torch.runtime import preview
from relativisticraytracer_tpu_torch.runtime.app import Session
from relativisticraytracer_tpu_torch.runtime.preview import PreviewServer, run_terminal_preview
from relativisticraytracer_tpu_torch.runtime.profiling import FrameTimer, march_stats, trace

torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parents[1]
SKY = jstarfield(16, 32)


def _tiny_session():
    scene = SceneConfig(max_steps=16, enable_clouds=False)
    settings = RenderSettings(width=32, height=16, max_steps=16, chunk=8)
    return Session(renderer=Renderer(scene, settings, skybox_rgba=SKY, device="cpu"))


@pytest.fixture
def sky_png(tmp_path):
    path = tmp_path / "sky.png"
    save_png(str(path), SKY)
    return str(path)


@pytest.fixture
def server(tmp_path, monkeypatch):
    monkeypatch.setattr("relativisticraytracer_tpu_torch.io.video.ffmpeg_available",
                        lambda: False)
    monkeypatch.chdir(tmp_path)
    srv = PreviewServer(_tiny_session(), host="127.0.0.1", port=0, fps_cap=60.0)
    srv.start()
    yield srv
    srv.stop()


def _req(srv, method, path):
    conn = http.client.HTTPConnection("127.0.0.1", srv.port, timeout=30)
    try:
        conn.request(method, path)
        resp = conn.getresponse()
        return resp.status, dict(resp.getheaders()), resp.read()
    finally:
        conn.close()


def test_page_and_status(server):
    status, _, body = _req(server, "GET", "/")
    assert status == 200 and b"/stream" in body
    status, _, body = _req(server, "GET", "/status")
    assert status == 200 and b"FPS" in body
    assert _req(server, "GET", "/nope")[0] == 404


def test_frame_jpg_is_jpeg(server):
    status, headers, body = _req(server, "GET", "/frame.jpg")
    assert status == 200 and headers["Content-Type"] == "image/jpeg"
    assert body[:2] == b"\xff\xd8"  # JPEG SOI
    from PIL import Image

    assert Image.open(io.BytesIO(body)).size == (32, 16)


def test_mjpeg_stream_delivers_frames(server):
    conn = http.client.HTTPConnection("127.0.0.1", server.port, timeout=30)
    try:
        conn.request("GET", "/stream")
        resp = conn.getresponse()
        assert "multipart/x-mixed-replace" in resp.getheader("Content-Type")
        data = b""
        deadline = time.time() + 30
        while data.count(b"--frame") < 2 and time.time() < deadline:
            data += resp.read1(65536)
        assert data.count(b"--frame") >= 2 and b"\xff\xd8" in data
    finally:
        conn.close()


def test_live_hotkeys(server):
    s = server.session
    assert s.effects.use_bloom == 1.0
    for key, field, want in (("b", "use_bloom", 0.0), ("v", "use_vignette", 0.0),
                             ("l", "use_lens_distortion", 0.0),
                             ("c", "use_chromatic_aberration", 1.0)):
        _req(server, "POST", f"/key?k={key}")
        assert getattr(s.effects, field) == want
    _req(server, "POST", "/key?k=p")
    assert s.paths.active
    _req(server, "POST", "/key?k=n")
    assert s.paths.current_path_index == 1
    _req(server, "POST", "/key?k=p")
    assert not s.paths.active
    yaw0 = s.camera.yaw
    _req(server, "POST", "/mouse?dx=50&dy=0")
    assert s.camera.yaw != yaw0
    x0 = s.camera.pos[0]
    _req(server, "POST", "/key?k=d")
    assert s.camera.pos[0] != x0
    _req(server, "POST", "/key?k=r")
    assert s.recorder.is_recording
    deadline = time.time() + 30
    while time.time() < deadline:
        if s.recorder._sink is not None and s.recorder._sink.frames_written():
            break
        time.sleep(0.05)
    _req(server, "POST", "/key?k=r")
    assert not s.recorder.is_recording


def test_terminal_preview():
    out = io.StringIO()
    session = _tiny_session()
    run_terminal_preview(session, frames=2, width=16, fps_cap=1000.0, out=out)
    session.close()
    text = out.getvalue()
    assert "▀" in text and "FPS" in text


def test_render_loop_error_surfaces():
    class ExplodingSession:
        def tick(self, dt):
            raise RuntimeError("card fell over")

        def status(self):
            return "FPS: 0"

        def close(self):
            pass

    srv = PreviewServer(ExplodingSession(), host="127.0.0.1", port=0)
    srv.start()
    try:
        deadline = time.time() + 10
        status = None
        while time.time() < deadline:
            status, _, body = _req(srv, "GET", "/status")
            if status == 500:
                break
            time.sleep(0.05)
        assert status == 500 and b"card fell over" in body
    finally:
        srv.stop()


def test_march_stats_accounts_all_rays():
    """march_stats of the port's plain march against the JAX march's at the
    same rays: the same captured / escaped / saturated shares."""
    from relativisticraytracer_tpu import config as jcfg
    from relativisticraytracer_tpu.render import camera as jcam
    from relativisticraytracer_tpu.render import march as jmarch
    from relativisticraytracer_tpu.runtime import profiling as jprof

    scene = SceneConfig(max_steps=1200, enable_disk=False, enable_clouds=False)
    cam = camera_state_from_pose((0.0, 2.0, -30.0), 0.0, 0.0)
    origin, direction, _, _ = generate_rays(32, 24, cam, effects_off(), "cpu")
    stats = march_stats(march(scene, origin, direction, 0.0, max_steps=1200))
    assert stats["rays"] == 32 * 24
    assert 0.0 < stats["captured"] < 1.0
    assert abs(stats["captured"] + stats["escaped"] + stats["saturated"] - 1.0) < 1e-6
    assert 0.0 <= stats["mean_transmittance"] <= 1.0
    jscene = jcfg.SceneConfig(max_steps=1200, enable_disk=False, enable_clouds=False)
    jo, jd, _, _ = jcam.generate_rays(32, 24, jcam.camera_state_from_pose(
        (0.0, 2.0, -30.0), 0.0, 0.0), jcfg.effects_off())
    want = jprof.march_stats(jmarch.march(jscene, jo, jd, 0.0, max_steps=1200))
    assert stats["rays"] == want["rays"]
    for key in ("captured", "saturated", "escaped", "mean_transmittance"):
        assert abs(stats[key] - want[key]) <= 2.0 / (32 * 24), key


def test_frame_timer_report():
    t = FrameTimer()
    for name in ("a", "a", "b"):
        with t.stage(name):
            pass
    rep = t.report()
    assert "a:" in rep and "(n=2)" in rep and "b:" in rep
    t.reset()
    assert t.report() == "(no stages timed)"


def test_trace_writes_a_chrome_trace(tmp_path):
    with trace(None) as prof:
        assert prof is None
    with trace(str(tmp_path / "tr")) as prof:
        torch.ones(64).sum()
    events = json.loads((tmp_path / "tr" / "trace.json").read_text())["traceEvents"]
    assert any("aten::" in e.get("name", "") for e in events)


def test_cli_paths_text_equals_jax(capsys):
    cli_main(["paths"])
    port = capsys.readouterr().out
    jax_cli_main(["paths"])
    assert port == capsys.readouterr().out
    assert "Gargantua Fly-By" in port and "[2]" in port


def test_cli_still(tmp_path, sky_png, capsys):
    out = tmp_path / "f.png"
    cli_main(["still", "--device", "cpu", "--width", "32", "--height", "24",
              "--max-steps", "16", "--skybox", sky_png, "--out", str(out)])
    assert load_image_rgba(str(out)).shape == (24, 32, 4)
    assert f"wrote {out} (32x24)" in capsys.readouterr().out


def test_cli_anim(tmp_path, monkeypatch, sky_png):
    monkeypatch.setattr("relativisticraytracer_tpu_torch.io.video.ffmpeg_available",
                        lambda: False)
    out = tmp_path / "a.mp4"
    cli_main(["anim", "--device", "cpu", "--width", "16", "--height", "8", "--max-steps", "8",
              "--fps", "2", "--duration", "1.0", "--skybox", sky_png, "--out", str(out),
              "--no-effects"])
    assert out.with_suffix(".rgba").stat().st_size == 2 * 16 * 8 * 4


def test_cli_interactive_args():
    with pytest.raises(SystemExit) as e:
        cli_main(["interactive", "--help"])
    assert e.value.code == 0
    with pytest.raises(SystemExit):
        cli_main(["interactive", "--loop", "fused"])  # not one of JAX's --loop choices


def test_cli_interactive_terminal(monkeypatch, capsys, sky_png):
    calls = {}
    real = preview.run_terminal_preview

    def capped(session, frames=0, width=100, fps_cap=15.0, out=None):
        calls["width"] = width
        return real(session, frames=1, width=width, fps_cap=1000.0, out=out)

    monkeypatch.setattr(preview, "run_terminal_preview", capped)
    cli_main(["interactive", "--device", "cpu", "--terminal", "--term-width", "24",
              "--width", "32", "--height", "16", "--max-steps", "8", "--no-clouds",
              "--skybox", sky_png])
    assert calls["width"] == 24
    assert "▀" in capsys.readouterr().out


def test_cli_preset_resolution(tmp_path, sky_png):
    out = tmp_path / "p.png"
    cli_main(["still", "--device", "cpu", "--preset", "realtime", "--height", "12",
              "--max-steps", "8", "--no-disk", "--no-clouds", "--skybox", sky_png,
              "--out", str(out)])
    assert load_image_rgba(str(out)).shape == (12, 480, 4)


def _error_line(fn, argv, capsys):
    """The `error: ...` text of an argparse usage error, or a SystemExit's
    message."""
    with pytest.raises(SystemExit) as e:
        fn(argv)
    err = capsys.readouterr().err
    return err.split("error: ", 1)[1].strip() if "error: " in err else str(e.value.code)


@pytest.mark.parametrize("devices", ["two", "0", "-3"])
def test_cli_devices_arg_errors_equal_jax(tmp_path, capsys, devices):
    base = ["anim", "--width", "8", "--height", "6", "--fps", "2", "--duration", "1.0",
            "--max-steps", "8", "--out", str(tmp_path / "f") + "/", "--devices", devices]
    assert _error_line(cli_main, base, capsys) == _error_line(jax_cli_main, base, capsys)


def test_cli_devices_beyond_the_cards(tmp_path, sky_png):
    """More --devices than CUDA cards fails loudly, as JAX's CLI fails for
    more than its devices."""
    n = torch.cuda.device_count() + 1
    with pytest.raises(SystemExit, match=f"--devices {n}: only {n - 1} device"):
        cli_main(["anim", "--device", "cpu", "--width", "8", "--height", "6", "--fps", "2",
                  "--duration", "1.0", "--max-steps", "8", "--skybox", sky_png,
                  "--out", str(tmp_path / "f") + "/", "--devices", str(n)])


@pytest.mark.parametrize("argv", [
    ["anim", "--path-index", "7"],
    ["anim", "--transfer", "yuv420p", "--width", "9", "--height", "6"],
    ["still", "--octave-cap", "0"],
    ["still", "--preset", "imax"],
])
def test_cli_errors_equal_jax(argv, capsys, sky_png, tmp_path):
    tail = ["--max-steps", "4", "--out", str(tmp_path / "x.mp4"), "--skybox", sky_png]
    port = _error_line(cli_main, argv + tail + ["--device", "cpu"], capsys)
    want = _error_line(jax_cli_main, argv + tail + ["--loop", "while"], capsys)
    assert port == want


def test_cli_interactive_defaults_to_realtime_preset(monkeypatch, sky_png):
    seen = {}

    def fake_preview(session, frames=0, width=100, fps_cap=15.0, out=None):
        seen["settings"] = session.renderer.settings
        seen["motion"] = session.motion_renderer

    monkeypatch.setattr(preview, "run_terminal_preview", fake_preview)
    cli_main(["interactive", "--device", "cpu", "--terminal", "--skybox", sky_png])
    assert (seen["settings"].width, seen["settings"].height) == (480, 272)
    assert seen["motion"] is not None and seen["motion"].settings.max_steps == 600
    cli_main(["interactive", "--device", "cpu", "--terminal", "--width", "32", "--height",
              "16", "--max-steps", "8", "--skybox", sky_png])
    assert (seen["settings"].width, seen["settings"].height) == (32, 16)
    assert seen["motion"] is None


def test_cli_interactive_explicit_motion_steps_zero(monkeypatch, sky_png):
    seen = {}
    monkeypatch.setattr(preview, "run_terminal_preview",
                        lambda session, **kw: seen.update(session=session))
    cli_main(["interactive", "--device", "cpu", "--terminal", "--motion-steps", "0",
              "--max-steps", "8", "--no-clouds", "--no-disk", "--skybox", sky_png])
    assert seen["session"].renderer.settings.width == 480
    assert seen["session"].motion_renderer is None


def test_cli_interactive_native_preset_motion_default(monkeypatch, sky_png, tmp_path):
    """--preset native gets the motion-step default (400); --state
    persists the session on exit."""
    seen = {}
    monkeypatch.setattr(preview, "run_terminal_preview",
                        lambda session, **kw: seen.update(session=session))
    state = tmp_path / "state.json"
    cli_main(["interactive", "--device", "cpu", "--terminal", "--preset", "native",
              "--no-clouds", "--no-disk", "--skybox", sky_png, "--state", str(state)])
    s = seen["session"]
    assert (s.renderer.settings.width, s.renderer.settings.height) == (1000, 700)
    assert s.motion_renderer is not None and s.motion_renderer.settings.max_steps == 400
    assert s.motion_renderer.sky.qr is s.renderer.sky.qr  # the same device skybox
    assert json.loads(state.read_text())["pos"] == [0.0, 10.0, -60.0]


def test_cli_octave_cap_flag(tmp_path, sky_png):
    out = tmp_path / "f.png"
    cli_main(["still", "--device", "cpu", "--width", "32", "--height", "24",
              "--max-steps", "16", "--octave-cap", "2", "--skybox", sky_png,
              "--out", str(out)])
    assert out.exists()
    assert SceneConfig().noise_octave_cap is None
    with pytest.raises(Exception):
        _positive_int("0")
    assert _positive_int("3") == 3


def test_cli_device_defaults_to_the_card(monkeypatch):
    """Every command renders on `cuda` unless --device says otherwise."""
    import relativisticraytracer_tpu_torch.__main__ as cli

    seen = []
    monkeypatch.setattr(cli, "_build_renderer", lambda args: seen.append(args.device)
                        or (_ for _ in ()).throw(SystemExit(0)))
    for cmd in ("still", "anim", "interactive"):
        with pytest.raises(SystemExit):
            cli_main([cmd])
    assert seen == ["cuda", "cuda", "cuda"]


PILLOW_FREE = r'''
import importlib, io, pathlib, pkgutil, sys, tempfile
sys.modules["PIL"] = None  # as on a machine without Pillow
import numpy as np
import relativisticraytracer_tpu_torch as pkg
for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
    importlib.import_module(m.name)
from relativisticraytracer_tpu_torch.io.image import (
    FrameSequenceWriter, load_image_rgba, load_skybox, save_png)
from relativisticraytracer_tpu_torch.runtime.preview import PreviewServer, run_terminal_preview
d = pathlib.Path(tempfile.mkdtemp())
frame = (np.arange(12 * 16 * 4) % 251).astype(np.uint8).reshape(12, 16, 4)
save_png(str(d / "f.png"), frame)
assert np.array_equal(load_image_rgba(str(d / "f.png")), frame)
assert np.array_equal(load_skybox(str(d / "f.png")), frame)
w = FrameSequenceWriter(str(d / "seq"), 16, 12, fps=24)
assert w.resume() == 0
w.capture(frame); w.capture(frame)
assert FrameSequenceWriter(str(d / "seq"), 16, 12, fps=24).resume() == 2
try:
    FrameSequenceWriter(str(d / "seq"), 16, 12, fps=30).resume()
    raise SystemExit("fps mismatch accepted")
except ValueError:
    pass

class Quiet:
    def tick(self, dt): return frame
    def status(self): return "FPS: 0"
    def close(self): pass
    quit_requested = False

out = io.StringIO()
run_terminal_preview(Quiet(), frames=1, width=8, fps_cap=1000.0, out=out)
assert "▀" in out.getvalue()
srv = PreviewServer(Quiet(), host="127.0.0.1", port=0)  # constructing needs no Pillow
try:
    srv.start()
    raise SystemExit("PreviewServer started without Pillow")
except ImportError as e:
    assert "Pillow" in str(e), e
print("ok")
'''


def test_everything_but_the_jpeg_preview_works_without_pillow():
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", PILLOW_FREE], capture_output=True, text=True,
                         cwd=ROOT, env=env, timeout=180)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
