"""PyTorch port: each hand-written CUDA kernel against its plain PyTorch
version on the card, and the CPU-side pieces of the kernel build.

The GPU tests carry the `gpu` marker and skip without a CUDA device. The
card's machine has no JAX, so this file imports none and does not need
tests/conftest.py:

    python -m pytest --noconftest tests/test_torch_kernels_gpu.py

Tolerances: the record and fused march kernels' hit masks agree with the
plain versions' on all but < 1e-3 of the pixels, and their quad indices
where hits agree; (I, T) and v to rtol 2e-6 / atol 5e-7
(tests/test_compact.py:180); the sky bitwise on unmasked pixels; frames
(inline vs compact, sharded vs whole) bitwise. Built with -fmad=false,
the kernels have matched their plain versions bitwise on an H100."""

import pathlib

import numpy as np
import pytest
import torch

from relativisticraytracer_tpu_torch.config import (
    CameraEffects,
    RenderSettings,
    SceneConfig,
    effects_off,
)
from relativisticraytracer_tpu_torch.core.vecmath import Vec3
from relativisticraytracer_tpu_torch.media.densities import cloud_probe_bounds, disk_probe_bounds
from relativisticraytracer_tpu_torch.ops import cuda_lib
from relativisticraytracer_tpu_torch.ops import pallas_compact as pc
from relativisticraytracer_tpu_torch.ops import pallas_march as pm
from relativisticraytracer_tpu_torch.ops import pallas_sky as ps
from relativisticraytracer_tpu_torch.ops.camera_rays import rays_from_scalars
from relativisticraytracer_tpu_torch.parallel.sharding import make_mesh, make_sharded_renderer
from relativisticraytracer_tpu_torch.render.camera import camera_state_from_pose
from relativisticraytracer_tpu_torch.render.pipeline import Renderer
from relativisticraytracer_tpu_torch.render.skybox import sky_coords, skybox_from_array

torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parent
SKY = np.load(ROOT / "torch_data" / "starfield_64x128.npy")
HEAD = ((0.0, 10.0, -60.0), 0.0, -10.0)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run on the card with "
                    "`python -m pytest --noconftest tests/test_torch_kernels_gpu.py`")
    return torch.device("cuda")


def _record_both(dev, slots=3, w=96, h=54, steps=2000, t=10.0):
    scal = pc.pack_camera_scalars(camera_state_from_pose(*HEAD), CameraEffects(), t)
    args = (SceneConfig(max_steps=steps), scal, w, h, steps, slots, 64, 128, dev)
    return pc._record_cuda(*args, None), pc._record_plain(*args)


@pytest.mark.gpu
def test_record_kernel_matches_plain(cuda):
    k, p = _record_both(cuda)
    hk, hp = k.hit > 0.5, p.hit > 0.5
    assert (hk != hp).float().mean().item() < 1e-3
    same = hk == hp
    assert torch.equal(k.idx[:, same], p.idx[:, same])
    torch.testing.assert_close(k.fx[:, same], p.fx[:, same], rtol=0, atol=1e-4)
    torch.testing.assert_close(k.fy[:, same], p.fy[:, same], rtol=0, atol=1e-4)
    assert (k.total > 0).any()


@pytest.mark.gpu
@pytest.mark.parametrize("sorted_order", [True, False])
def test_replay_kernel_matches_plain(cuda, sorted_order):
    k, _ = _record_both(cuda)
    scene = SceneConfig()
    order = pc.replay_order(k.total) if sorted_order else None
    ik, tk = pc.media_replay(scene, k.rec, 10.0, order=order)
    sel = (order if sorted_order else torch.arange(k.hit.numel(), device=cuda,
                                                    dtype=torch.int32)).long()
    ip, tp = pc._replay_plain(scene, k.rec, 10.0, sel)
    got = torch.stack(list(ik)).reshape(3, -1)[:, sel]
    torch.testing.assert_close(got, ip, rtol=2e-6, atol=5e-7)
    torch.testing.assert_close(tk.reshape(-1)[sel], tp, rtol=2e-6, atol=5e-7)


@pytest.mark.gpu
def test_replay_kernel_merge_is_exact(cuda):
    """slots=1 merges every later crossing into the first record; gap steps
    add exact zeros, and the per-thread replay is bitwise."""
    k3, _ = _record_both(cuda, slots=3)
    k1, _ = _record_both(cuda, slots=1)
    a = pc.media_replay_sorted(SceneConfig(), k3, 10.0)
    b = pc.media_replay_sorted(SceneConfig(), k1, 10.0)
    for x, y in zip(list(a[0]) + [a[1]], list(b[0]) + [b[1]]):
        assert torch.equal(x, y)


@pytest.mark.gpu
@pytest.mark.parametrize("ca", [0.0, 0.01])
@pytest.mark.parametrize("q4", [True, False])
def test_sky_kernel_bitwise_on_unmasked(cuda, ca, q4):
    rng = np.random.default_rng(5)
    sky = skybox_from_array(SKY, cuda)
    if not q4:
        sky = sky._replace(q4=None)
    v = rng.standard_normal((3, 64, 96)).astype(np.float32)
    v /= np.linalg.norm(v, axis=0, keepdims=True)
    d = Vec3(*(torch.as_tensor(c, device=cuda) for c in v))
    eff = CameraEffects(use_chromatic_aberration=1.0 if ca else 0.0, ca_amount=ca or 0.005)
    coords = sky_coords(d, eff.ca_offset(), *sky.shape)
    idx, fx, fy = (torch.stack([c[j] for c in coords]) for j in range(3))
    masked = torch.as_tensor(rng.random((64, 96)) < 0.3, device=cuda)
    got = torch.stack(list(ps.sky_background_windowed(sky, idx, fx, fy, eff, masked)))
    want = ps._sky_plain(sky, idx, fx, fy, eff, masked)
    assert torch.equal(got[:, ~masked], want[:, ~masked])
    assert (got[:, masked] == 0).all()


@pytest.mark.gpu
@pytest.mark.parametrize("name,kw,fx_on", [
    ("schwarzschild_vacuum", dict(enable_disk=False, enable_clouds=False), False),
    ("kerr09_vacuum", dict(enable_disk=False, enable_clouds=False, spin_a=0.9), False),
    ("disk_only", dict(enable_clouds=False), False),
    ("full_scene_fx", dict(), True),
])
def test_renderer_on_the_card_passes_goldens(cuda, name, kw, fx_on):
    lib = cuda_lib.kernels()
    lib.reset_launches()
    r = Renderer(SceneConfig(max_steps=400, **kw),
                 RenderSettings(width=64, height=48, max_steps=400),
                 skybox_rgba=SKY, device=cuda)
    got = r.render_np(camera_state_from_pose((0.0, 5.0, -38.0), 0.0, -6.0),
                      CameraEffects() if fx_on else effects_off(), 2.0)
    want = np.load(ROOT / "goldens" / f"{name}.npy")
    d = got[..., :3].astype(int) - want[..., :3].astype(int)
    assert np.sqrt(np.mean((d / 255.0) ** 2)) < 1e-3
    # no medium: the fused inline march (kernel 4), as in the JAX package
    ran = {"march_sky"} if not kw.get("enable_disk", True) else {"record", "replay", "sky"}
    assert lib.launches == {k: int(k in ran) for k in cuda_lib.KERNELS}


def _march_both(dev, kernel, w=96, h=54, steps=2000, t=10.0):
    """(kernel, plain) outputs of one fused march kernel at the headline
    pose; the plane kernel marches the camera's rays from memory."""
    scene = SceneConfig(max_steps=steps)
    scal = pc.pack_camera_scalars(camera_state_from_pose(*HEAD), CameraEffects(), t)
    if kernel == "sky":
        args = (scene, scal, w, h, steps, 64, 128, dev)
        return pm._march_camera_sky_cuda(*args), pm._march_camera_sky_plain(*args)
    if kernel == "camera":
        args = (scene, scal, w, h, steps, dev)
        return pm._march_camera_cuda(*args), pm._march_camera_plain(*args)
    o, d = rays_from_scalars(scal, w, h, dev)
    return (pm._march_planes_cuda(scene, o, d, t, steps),
            pm._march_plain(scene, o, d, t, steps))


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", ["sky", "camera", "planes"])
def test_march_kernels_match_plain(cuda, kernel):
    """Kernels 4-6 against the plain march on the card: hit masks agree but
    for < 1e-3 of the pixels, (I, T) (and v, or the sky indices) where
    they agree to rtol 2e-6 / atol 5e-7; expected bitwise."""
    k, p = _march_both(cuda, kernel)
    if kernel == "sky":  # no hit plane: captured rays have T exactly 0
        same = (k[1] == 0) == (p[1] == 0)
        assert (~same).float().mean().item() < 1e-3
        assert torch.equal(k[2][:, same], p[2][:, same])
        rest = [(k[3], p[3]), (k[4], p[4])]
    else:
        assert (k[2] != p[2]).float().mean().item() < 1e-3
        same = k[2] == p[2]
        rest = [(torch.stack(list(k[3])), torch.stack(list(p[3])))]
    pairs = [(torch.stack(list(k[0])), torch.stack(list(p[0]))), (k[1][None], p[1][None])]
    for got, want in pairs + rest:
        torch.testing.assert_close(got[:, same], want[:, same], rtol=2e-6, atol=5e-7)
    assert (k[1] < 1.0).any() and (k[1] == 0.0).any()  # media and captures


@pytest.mark.gpu
def test_record_kernel_shard_is_a_crop(cuda):
    """The record kernel with a shard origin and strip maps is bitwise the
    matching rows/columns of the full-frame record."""
    scene = SceneConfig(max_steps=400)
    cam = camera_state_from_pose(*HEAD)
    full = pc.march_pallas_camera_sky_record(scene, cam, CameraEffects(), 2.0, 96, 64, 400,
                                             64, 128, device=cuda)
    rows = [(r // 8) * 16 + r % 8 + 8 for r in range(32)]
    cols = [(c // 16) * 48 + c % 16 + 16 for c in range(32)]
    shard = pc.march_pallas_camera_sky_record(
        scene, cam, CameraEffects(), 2.0, 32, 32, 400, 64, 128, device=cuda,
        origin=(16.0, 8.0), img_w=96, img_h=64, strips=(8, 16), cstrips=(16, 48))
    for got, want in zip(shard, full):
        assert torch.equal(got, want[..., rows, :][..., cols])


@pytest.mark.gpu
@pytest.mark.parametrize("slots", [3, 1])
def test_inline_frame_equals_compact_frame_on_the_card(cuda, slots):
    scene = SceneConfig(max_steps=2000)
    sky = skybox_from_array(SKY, cuda)
    cam = camera_state_from_pose(*HEAD)
    frames = [Renderer(scene, RenderSettings(width=192, height=108, media_pass=mp,
                                             media_slots=slots),
                       skybox=sky, device=cuda).render(cam, CameraEffects(), 10.0)
              for mp in ("compact", "inline")]
    assert torch.equal(frames[0], frames[1])


@pytest.mark.gpu
@pytest.mark.parametrize("media_pass", ["compact", "inline"])
def test_sharded_frame_on_one_card(cuda, media_pass):
    """A 4x2 grid of one card, shards one after another: tiled == untiled."""
    scene = SceneConfig(max_steps=2000)
    settings = RenderSettings(width=192, height=112, media_pass=media_pass)
    sky = skybox_from_array(SKY, cuda)
    cam = camera_state_from_pose(*HEAD)
    fn = make_sharded_renderer(scene, settings, make_mesh([cuda] * 8, (4, 2)))
    tiled = fn.reassemble(fn(cam, CameraEffects(), 10.0, sky))
    whole = Renderer(scene, settings, skybox=sky, device=cuda).render_np(
        cam, CameraEffects(), 10.0)
    np.testing.assert_array_equal(tiled, whole)


def test_scene_consts_fold_like_the_jax_package():
    """Each constant is the Python-double expression rounded to float32
    once, as JAX folds it before meeting a float32 array."""
    f32 = lambda x: float(np.float32(x))  # noqa: E731
    for scene in (SceneConfig(), SceneConfig(spin_a=0.9, mass_pos=(0.0, 1.0, 0.0),
                                             noise_octave_cap=2, enable_clouds=False)):
        c = cuda_lib.scene_consts(scene)
        eh = scene.event_horizon
        assert c.radial_k == f32(-1.5 * eh) and c.capture_r2 == f32((eh * 1.01) ** 2)
        assert c.inside_r2 == f32((eh * 0.5) * (eh * 0.5))
        assert c.escape_r2 == f32(scene.escape_radius ** 2)
        assert c.step_size == f32(scene.step_size_m)
        assert (c.disk_k2, c.disk_rlo2, c.disk_rhi2) == tuple(map(f32, disk_probe_bounds(scene)))
        assert (c.cloud_k2, c.cloud_rlo2, c.cloud_rhi2) == tuple(
            map(f32, cloud_probe_bounds(scene)))
        assert c.edge_width == f32(scene.disk_out_m - scene.disk_out_m * 0.85)
        assert c.cloud_edge_w == f32(scene.disk_out_m * 0.8 - scene.disk_out_m)
        assert list(c.mass_pos) == list(map(f32, scene.mass_pos))
        assert (c.enable_disk, c.enable_clouds) == (scene.enable_disk, scene.enable_clouds)
        assert c.has_spin == (scene.spin_a != 0.0)
        assert c.has_mass_pos == (scene.mass_pos != (0.0, 0.0, 0.0))
        assert (c.oct5, c.oct2) == (scene.octaves(5), scene.octaves(2))
    with pytest.raises(ValueError, match="16 camera scalars"):
        cuda_lib.cam_scalars(np.zeros(15, np.float32))


def test_fp64_scan_allows_only_the_trig_slow_path():
    ptx = "\n".join([
        "\t.reg .f64 \t%fd<5>;",
        "\tcvt.rn.f64.s64 \t%fd1, %rd53;",
        "\tmul.rn.f64 \t%fd2, %fd1, 0d3BF921FB54442D19;",
        "\tmul.f64 \t%fd4, %fd3, 0d3BF921FB54442D19;",
        "\tcvt.rn.f32.f64 \t%f845, %fd2;",
        "\tmul.rn.f32 \t%f1, %f2, %f3;",
    ])
    assert cuda_lib.fp64_instructions(ptx) == []
    bad = ptx + "\n\tadd.rn.f64 \t%fd3, %fd1, %fd2;\n\tcvt.f64.f32 \t%fd1, %f1;"
    assert cuda_lib.fp64_instructions(bad) == ["add.rn.f64 \t%fd3, %fd1, %fd2;",
                                               "cvt.f64.f32 \t%fd1, %f1;"]


def test_kernel_wrappers_refuse_cpu_tensors():
    """The wrappers' checks run before any launch: a CPU tensor handed to
    a kernel is an error, never a silent plain-version run."""
    z = torch.zeros((4, 8), dtype=torch.float32)
    for t in (z, z.to("meta")):
        with pytest.raises(ValueError, match="CUDA device"):
            cuda_lib.check("record", [(t, torch.float32, (4, 8))])
