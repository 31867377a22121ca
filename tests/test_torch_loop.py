"""PyTorch port: `RenderSettings.loop` picks the frame program, as in the
JAX package (render/pipeline._compiled_render, parallel/sharding,
__main__ --loop), and the fuzz tool built on it (tools/fuzz_parity.py,
the port of tools/tpu_fuzz_parity.py).

"while" and "scan" run the plain march (render/pipeline.render_frame) and
are held against JAX's Renderer with the same `loop` on the same inputs
(the committed starfield) at RMSE < 1e-3 (bench.py:84-89); "auto" and
"pallas" run the kernel programs (their plain versions on the CPU); any
other value raises JAX's ValueError. Everything runs on the CPU at golden
sizes."""

import json
import pathlib

import numpy as np
import pytest
import torch

from relativisticraytracer_tpu.config import CameraEffects as JEffects
from relativisticraytracer_tpu.config import RenderSettings as JSettings
from relativisticraytracer_tpu.config import SceneConfig as JScene
from relativisticraytracer_tpu.parallel import sharding as jsh
from relativisticraytracer_tpu.render import camera as jcam
from relativisticraytracer_tpu.render.pipeline import Renderer as JRenderer
from relativisticraytracer_tpu_torch.__main__ import main as cli_main
from relativisticraytracer_tpu_torch.config import CameraEffects as TEffects
from relativisticraytracer_tpu_torch.config import RenderSettings as TSettings
from relativisticraytracer_tpu_torch.config import SceneConfig as TScene
from relativisticraytracer_tpu_torch.io.image import decode_png, save_png
from relativisticraytracer_tpu_torch.ops import pallas_compact as pc
from relativisticraytracer_tpu_torch.ops import pallas_march as pm
from relativisticraytracer_tpu_torch.parallel import sharding as tsh
from relativisticraytracer_tpu_torch.paths import default_paths, interpolate_path
from relativisticraytracer_tpu_torch.render import camera as tcam
from relativisticraytracer_tpu_torch.render import march as tmarch
from relativisticraytracer_tpu_torch.render import pipeline
from relativisticraytracer_tpu_torch.render.pipeline import Renderer
from relativisticraytracer_tpu_torch.render.skybox import skybox_from_array
from relativisticraytracer_tpu_torch.runtime.app import AnimationJob, Session
from relativisticraytracer_tpu_torch.tools import fuzz_parity

torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parents[1]
SKY_RGBA = np.load(ROOT / "tests" / "torch_data" / "starfield_64x128.npy")
SKY = skybox_from_array(SKY_RGBA, "cpu")
POSE = ((0.0, 5.0, -38.0), 0.0, -6.0)
STEPS = 120


def _rmse(a, b) -> float:
    d = a[..., :3].astype(np.int64) - b[..., :3].astype(np.int64)
    return float(np.sqrt(np.mean((d / 255.0) ** 2)))


@pytest.fixture
def kernel_calls(monkeypatch):
    """Counts the calls of the kernel programs' plain versions (the record
    and the fused camera march) that the frame programs make on the CPU."""
    calls = {"record": 0, "march_sky": 0}

    def spy(name, fn):
        def wrapped(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)
        return wrapped

    monkeypatch.setattr(pc, "_record_plain", spy("record", pc._record_plain))
    monkeypatch.setattr(pm, "_march_camera_sky_plain",
                        spy("march_sky", pm._march_camera_sky_plain))
    return calls


@pytest.mark.parametrize("loop", ["while", "scan"])
def test_plain_loops_match_jax_renderer(loop, kernel_calls):
    """Renderer(loop="while"|"scan") runs render_frame, the plain march,
    and matches JAX's Renderer with the same loop (the full scene with
    effects, 64x48, 120 steps)."""
    want = JRenderer(JScene(max_steps=STEPS),
                     JSettings(width=64, height=48, max_steps=STEPS, loop=loop),
                     skybox_rgba=SKY_RGBA).render_np(jcam.camera_state_from_pose(*POSE),
                                                     JEffects(), 2.0)
    r = Renderer(TScene(max_steps=STEPS), TSettings(width=64, height=48, max_steps=STEPS,
                                                    loop=loop),
                 skybox=SKY, device="cpu")
    assert r._fn is pipeline.render_frame
    got = r.render_np(tcam.camera_state_from_pose(*POSE), TEffects(), 2.0)
    assert got.shape == want.shape == (48, 64, 4) and got.dtype == np.uint8
    e = _rmse(got, want)
    assert e < 1e-3, f"loop={loop}: RMSE {e}"
    assert kernel_calls == {"record": 0, "march_sky": 0}


def test_scan_march_is_the_while_march_bitwise():
    """loop="scan" (a fixed trip count over every ray) and "while" (finished
    rays dropped every chunk, early exit) give bitwise the same state, as
    the JAX package's two loops do (tests/test_march.py:82)."""
    cam = tcam.camera_state_from_pose(*POSE)
    o, d, _, _ = tcam.generate_rays(24, 16, cam, TEffects(), "cpu")
    scene = TScene(max_steps=STEPS)
    a = tmarch.march(scene, o, d, torch.tensor(2.0), STEPS, loop="scan")
    b = tmarch.march(scene, o, d, torch.tensor(2.0), STEPS, loop="while", chunk=64)
    for x, y in zip(list(a.p) + list(a.v) + list(a.intensity) + [a.transmittance],
                    list(b.p) + list(b.v) + list(b.intensity) + [b.transmittance]):
        assert torch.equal(x, y)
    assert torch.equal(a.hit_horizon, b.hit_horizon) and torch.equal(a.active, b.active)


@pytest.mark.parametrize("media_pass,program,plain", [
    ("compact", "render_frame_pallas_compact", "record"),
    ("inline", "render_frame_pallas", "march_sky"),
])
def test_auto_and_pallas_run_the_kernel_programs(media_pass, program, plain, kernel_calls):
    """loop="auto" (default) and "pallas" dispatch to the kernel programs
    (on the CPU their plain versions run) and render the same bytes; the
    plain march frame agrees within the gate."""
    scene = TScene(max_steps=STEPS)
    cam = tcam.camera_state_from_pose(*POSE)
    frames = {}
    for loop in ("auto", "pallas", "while"):
        r = Renderer(scene, TSettings(width=48, height=32, max_steps=STEPS, loop=loop,
                                      media_pass=media_pass), skybox=SKY, device="cpu")
        before = dict(kernel_calls)
        frames[loop] = r.render_np(cam, TEffects(), 2.0)
        ran = kernel_calls[plain] - before[plain]
        if loop == "while":
            assert r._fn is pipeline.render_frame and ran == 0
        else:
            assert r._fn is getattr(pipeline, program) and ran == 1
    np.testing.assert_array_equal(frames["auto"], frames["pallas"])
    assert _rmse(frames["pallas"], frames["while"]) < 1e-3


def test_unknown_loop_raises_like_jax():
    """JAX raises ValueError("unknown loop strategy ...") at its first
    render; the port raises the same message when the renderer is built,
    and so do its march and the shard renderer."""
    with pytest.raises(ValueError) as jerr:
        JRenderer(JScene(max_steps=8), JSettings(width=8, height=4, loop="fused")).render_np(
            jcam.camera_state_from_pose(*POSE))
    with pytest.raises(ValueError) as terr:
        Renderer(TScene(max_steps=8), TSettings(width=8, height=4, loop="fused"),
                 device="cpu").render(tcam.camera_state_from_pose(*POSE))
    assert str(terr.value) == str(jerr.value) == "unknown loop strategy 'fused'"
    o, d, _, _ = tcam.generate_rays(4, 2, tcam.default_camera(), TEffects(), "cpu")
    with pytest.raises(ValueError, match="unknown loop strategy 'fused'"):
        tmarch.march(TScene(max_steps=8), o, d, 0.0, 8, loop="fused")
    mesh = tsh.make_mesh(["cpu"] * 2, (2, 1))
    with pytest.raises(ValueError, match="unknown loop strategy 'fused'"):
        tsh.make_sharded_renderer(TScene(max_steps=8), TSettings(width=8, height=4,
                                                                 loop="fused"), mesh)
    with pytest.raises(ValueError, match="unknown loop strategy 'fused'"):
        tsh.render_frame_sharded(TScene(max_steps=8), TSettings(width=8, height=4, loop="fused"),
                                 mesh, tcam.default_camera(), TEffects(), 0.0, SKY)


def test_session_and_animation_job_follow_loop(tmp_path, kernel_calls):
    """Session and AnimationJob render through their Renderer, so a
    settings' loop="while" reaches them with no code of their own."""
    scene = TScene(max_steps=16)
    settings = TSettings(width=16, height=8, max_steps=16, loop="while")
    session = Session(scene=scene, settings=settings, skybox_rgba=SKY_RGBA, device="cpu")
    assert session.renderer._fn is pipeline.render_frame
    frame = session.tick(0.0)
    assert frame.shape == (8, 16, 4)
    renderer = Renderer(scene, settings, skybox=SKY, device="cpu")
    job = AnimationJob(path=default_paths()[0], renderer=renderer, fps=2, duration=1.0,
                       out_path=str(tmp_path / "seq") + "/")
    stats = job.run()
    assert stats["frames_written"] == 2
    # frame 0 at path time 1 / fps (the clock advances before the render)
    cam = tcam.camera_state_from_pose(*interpolate_path(default_paths()[0], 0.5))
    got = decode_png(tmp_path / "seq" / "frame_00000.png")
    np.testing.assert_array_equal(got, renderer.render_np(cam, TEffects(), 0.5))
    assert kernel_calls == {"record": 0, "march_sky": 0}


@pytest.mark.parametrize("loop", ["while", "scan"])
@pytest.mark.parametrize("shape", [(2, 1), (1, 2), (2, 2)])
def test_sharded_plain_loop_tiled_equals_untiled(loop, shape):
    """The shard renderer under a plain loop runs render_hdr on each tile's
    cut ray planes with sample_sky; tiled == untiled byte for byte."""
    scene = TScene(max_steps=80)
    settings = TSettings(width=24, height=16, max_steps=80, loop=loop)
    cam = tcam.camera_state_from_pose(*POSE)
    fx = TEffects(use_chromatic_aberration=1.0, ca_amount=0.004)
    mesh = tsh.make_mesh(["cpu"] * (shape[0] * shape[1]), shape)
    fn = tsh.make_sharded_renderer(scene, settings, mesh)
    tiled = fn.reassemble(fn(cam, fx, 1.0, SKY))
    whole = Renderer(scene, settings, skybox=SKY, device="cpu").render_np(cam, fx, 1.0)
    np.testing.assert_array_equal(tiled, whole)


def test_shard_interleave_follows_loop_like_jax():
    """interleave="auto" resolves False off the kernel loop, and
    interleave=True there raises JAX's error (sharding.py:159-163,
    :215-225)."""
    jmesh = type("M", (), {"devices": np.empty((2, 1))})()
    for loop in ("while", "scan", "pallas", "auto"):
        for media_pass in ("compact", "inline"):
            t = tsh.resolve_interleave(TScene(), TSettings(loop=loop, media_pass=media_pass),
                                       "auto")
            j = jsh.resolve_interleave(JScene(), JSettings(
                loop="pallas" if loop == "auto" else loop, media_pass=media_pass), "auto")
            assert t == j == (loop in ("auto", "pallas") and media_pass == "compact")
    for loop in ("while", "scan"):
        with pytest.raises(ValueError) as jerr:
            jsh.render_frame_sharded(JScene(max_steps=8), JSettings(width=8, height=4, loop=loop),
                                     jmesh, None, None, 0.0, None, interleave=True)
        with pytest.raises(ValueError) as terr:
            tsh.render_frame_sharded(TScene(max_steps=8), TSettings(width=8, height=4, loop=loop),
                                     tsh.make_mesh(["cpu"] * 2, (2, 1)), tcam.default_camera(),
                                     TEffects(), 0.0, SKY, interleave=True)
        assert str(terr.value) == str(jerr.value)


def test_cli_loop_choices_render(tmp_path, capsys):
    """--loop takes JAX's choices and renders a tiny still on the CPU; the
    plain march's stills ("while", "scan") are the same bytes, and the
    kernel program's agrees with them within the gate."""
    sky_png = tmp_path / "sky.png"
    save_png(sky_png, SKY_RGBA)
    frames = {}
    for loop in ("while", "scan", "pallas"):
        out = tmp_path / f"{loop}.png"
        cli_main(["still", "--device", "cpu", "--loop", loop, "--width", "32", "--height", "24",
                  "--max-steps", "32", "--skybox", str(sky_png), "--out", str(out)])
        frames[loop] = decode_png(out)
        assert frames[loop].shape == (24, 32, 4)
    np.testing.assert_array_equal(frames["while"], frames["scan"])
    assert fuzz_parity.compare(frames["pallas"], frames["while"], 1)["ok"]
    with pytest.raises(SystemExit):
        cli_main(["still", "--device", "cpu", "--loop", "fused"])
    assert "invalid choice" in capsys.readouterr().err


def test_fuzz_parity_runs_on_cpu_with_jax_report_keys():
    """fuzz_parity.run on the CPU: the kernel programs' plain versions
    against the plain march, both programs, sharing the plain frames."""
    plain = {}
    reports = [fuzz_parity.run(cases=3, width=32, height=24, max_steps=64, media_pass=mp,
                               device="cpu", plain_frames=plain, log=None)
               for mp in ("compact", "inline")]
    assert sorted(plain) == [0, 1, 2]
    for rep in reports:
        assert {"platform", "cases", "max_lsb_budget", "worst_lsb", "pass"} <= set(rep)
        assert rep["pass"] and rep["platform"] == "cpu" and len(rep["cases"]) == 3
        for c in rep["cases"]:
            assert {"spin", "pos", "yaw", "pitch", "time", "max_lsb", "mismatch_frac"} <= set(c)
            assert c["ok"] and c["rmse"] < 1e-3 and c["over_lsb_frac"] < 1e-3
    json.dumps(reports)


def test_fuzz_parity_main_writes_its_report_and_fails_loudly(tmp_path, monkeypatch, capsys):
    """main() writes chiprun_out/fuzz_parity.json (here a temporary
    directory) and exits 1 when a case fails."""
    monkeypatch.setattr(fuzz_parity, "OUT", tmp_path)
    argv = ["--cases", "1", "--width", "16", "--height", "8", "--max-steps", "16",
            "--device", "cpu"]
    rep = fuzz_parity.main(argv)
    assert rep["pass"]
    assert json.loads((tmp_path / "fuzz_parity.json").read_text())["cases"] == rep["cases"]
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1])["pass"] is True
    monkeypatch.setattr(fuzz_parity, "compare", lambda got, want, lsb: dict(
        max_lsb=9, mismatch_frac=0.5, rmse=0.1, over_lsb_frac=0.5, ok=False))
    with pytest.raises(SystemExit) as e:
        fuzz_parity.main(argv)
    assert e.value.code == 1


def test_fuzz_parity_poses_are_the_tpu_tools():
    """Case k of the port's tool is case k of the JAX tool's report
    (docs/tpu_fuzz.json): the same draws in the same order."""
    want = json.loads((ROOT / "docs" / "tpu_fuzz.json").read_text())["cases"]
    got = list(fuzz_parity.poses(len(want), 7))
    assert len(got) == 24
    for (spin, pos, yaw, pitch, t), w in zip(got, want):
        assert spin == w["spin"]
        assert [round(p, 2) for p in pos] == w["pos"]
        assert (round(yaw, 1), round(pitch, 1), round(t, 2)) == (w["yaw"], w["pitch"], w["time"])
