"""PyTorch port: each hand-written CUDA kernel against its plain PyTorch
version on the card, and the CPU-side pieces of the kernel build.

The GPU tests carry the `gpu` marker and skip without a CUDA device. The
card's machine has no JAX, so this file imports none and does not need
tests/conftest.py:

    python -m pytest --noconftest tests/test_torch_kernels_gpu.py

Tolerances: the record and fused march kernels' hit masks agree with the
plain versions' on all but < 1e-3 of the pixels, and their quad indices
where hits agree; (I, T) and v to rtol 2e-6 / atol 5e-7
(tests/test_compact.py:180); the replay and the sky (on unmasked pixels)
bitwise; frames (inline vs compact, sharded vs whole) bitwise. Built with -fmad=false,
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
from relativisticraytracer_tpu_torch.core.vecmath import Vec3, fdiv, normalize
from relativisticraytracer_tpu_torch.media.densities import cloud_probe_bounds, disk_probe_bounds
from relativisticraytracer_tpu_torch.ops import cuda_lib
from relativisticraytracer_tpu_torch.ops import pallas_compact as pc
from relativisticraytracer_tpu_torch.ops import pallas_march as pm
from relativisticraytracer_tpu_torch.ops import pallas_sky as ps
from relativisticraytracer_tpu_torch.ops.camera_rays import rays_from_scalars
from relativisticraytracer_tpu_torch.parallel.sharding import (
    make_mesh,
    make_sharded_renderer,
    tile_background,
)
from relativisticraytracer_tpu_torch.render.camera import camera_state_from_pose
from relativisticraytracer_tpu_torch.render.march import adaptive_h
from relativisticraytracer_tpu_torch.render.pipeline import Renderer
from relativisticraytracer_tpu_torch.render.skybox import (
    sample_sky_fast,
    sky_coords,
    skybox_from_array,
)

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
    """The replay's march, shade and composite kernels give each ray the
    plain replay's (I, T) bitwise, for the longest-first list built on the
    device and for image order; every ray fits the step list, so the
    per-ray kernel launches and does nothing."""
    k, _ = _record_both(cuda)
    scene = SceneConfig()
    lib = cuda_lib.kernels()
    lib.reset_launches()
    if sorted_order:
        order = pc.replay_order(k.total)
        ik, tk = pc.media_replay_sorted(scene, k, 10.0)
    else:
        order = torch.arange(k.hit.numel(), device=cuda, dtype=torch.int32)
        ik, tk = pc.media_replay(scene, k.rec, 10.0)
    assert all(lib.launches[name] == 1 for name in cuda_lib.REPLAY_PASSES)
    sel = order.long()
    ip, tp = pc._replay_plain(scene, k.rec, 10.0, sel)
    assert torch.equal(torch.stack(list(ik)).reshape(3, -1)[:, sel], ip)
    assert torch.equal(tk.reshape(-1)[sel], tp)


@pytest.mark.gpu
@pytest.mark.parametrize("capacity", ["one step", "half"])
@pytest.mark.parametrize("sorted_order", [True, False])
def test_replay_overflow_kernel_bitwise(cuda, capacity, sorted_order):
    """A step list too small for the frame: the rays past it go to the
    per-ray kernel, and every ray's (I, T) is bitwise the unforced replay's
    and the plain replay's (capacity 1 sends every ray there)."""
    k, _ = _record_both(cuda)
    scene = SceneConfig()
    n_steps = pc.replay_list(k.total)[1]
    cap = 1 if capacity == "one step" else n_steps // 2

    def run(c):
        if sorted_order:
            return pc.media_replay_sorted(scene, k, 10.0, capacity=c)
        return pc.media_replay(scene, k.rec, 10.0, capacity=c)

    want_i, want_t = run(None)
    got_i, got_t = run(cap)
    assert torch.equal(torch.stack(list(got_i)), torch.stack(list(want_i)))
    assert torch.equal(got_t, want_t)
    sel = pc.replay_order(k.total).long()
    ip, tp = pc._replay_plain(scene, k.rec, 10.0, sel)
    assert torch.equal(torch.stack(list(got_i)).reshape(3, -1)[:, sel], ip)
    assert torch.equal(got_t.reshape(-1)[sel], tp)


@pytest.mark.gpu
def test_replay_grids_stride_past_one_wave(cuda):
    """At 1080p in image order every pixel is listed: the march, shade and
    composite grids (one wave each) stride over millions of segments,
    steps and rays, and at a capacity of one step the per-ray kernel
    strides over every pixel. Each gives the longest-first list's (I, T)
    bitwise."""
    scene = SceneConfig()
    scal = pc.pack_camera_scalars(camera_state_from_pose(*HEAD), CameraEffects(), 10.0)
    k = pc._record_cuda(scene, scal, 1920, 1080, 2000, pc.SLOTS, 64, 128, cuda, None)
    want = pc.media_replay_sorted(scene, k, 10.0)
    for cap in (None, 1):
        got = pc.media_replay(scene, k.rec, 10.0, capacity=cap)
        assert torch.equal(torch.stack(list(got[0])), torch.stack(list(want[0])))
        assert torch.equal(got[1], want[1])


@pytest.mark.gpu
def test_render_on_returns_before_the_frame_is_done(cuda):
    """The compact frame program enqueues its whole 1080p frame without
    waiting for the device: an event recorded right after render_on
    returns has not completed (the record kernel alone takes ~20 ms)."""
    r = Renderer(SceneConfig(), RenderSettings(width=1920, height=1080),
                 skybox_rgba=SKY, device=cuda)
    cam = camera_state_from_pose(*HEAD)
    r.render(cam, CameraEffects(), 1.0)  # build the kernels, warm the allocator
    torch.cuda.synchronize()
    frame = r.render_on(None, cam, CameraEffects(), 1.0)
    done = torch.cuda.Event()
    done.record()
    assert not done.query()
    torch.cuda.synchronize()
    assert frame.shape == (1080, 1920, 4) and frame.dtype == torch.uint8


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
@pytest.mark.parametrize("ca", [0.0, 0.01])
@pytest.mark.parametrize("q4", [True, False])
@pytest.mark.parametrize("mask", [True, False])
def test_sky_kernel_ragged_n_and_no_mask(cuda, ca, q4, mask):
    """n % 4 != 0 (the kernel's scalar loads) and no mask (the inline
    frame's call): bitwise the plain gather on every unmasked pixel."""
    rng = np.random.default_rng(11)
    sky = skybox_from_array(SKY, cuda)
    if not q4:
        sky = sky._replace(q4=None)
    shape = (37, 59)  # n = 2183, n % 4 = 3
    v = rng.standard_normal((3,) + shape).astype(np.float32)
    v /= np.linalg.norm(v, axis=0, keepdims=True)
    d = Vec3(*(torch.as_tensor(c, device=cuda) for c in v))
    eff = CameraEffects(use_chromatic_aberration=1.0 if ca else 0.0, ca_amount=ca or 0.005)
    coords = sky_coords(d, eff.ca_offset(), *sky.shape)
    idx, fx, fy = (torch.stack([c[j] for c in coords]) for j in range(3))
    masked = torch.as_tensor(rng.random(shape) < 0.3, device=cuda) if mask else None
    got = torch.stack(list(ps.sky_background_windowed(sky, idx, fx, fy, eff, masked)))
    want = ps._sky_plain(sky, idx, fx, fy, eff, masked)
    keep = ~masked if mask else torch.ones(shape, dtype=torch.bool, device=cuda)
    assert torch.equal(got[:, keep], want[:, keep])
    assert (got[:, ~keep] == 0).all()


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
    # no medium: the fused inline march (kernel 4) and the sky kernel, as
    # in the JAX package; else record, the replay's kernels (no cloud pass
    # without clouds), sky
    if not kw.get("enable_disk", True):
        ran = {"march_sky", "sky"}
    else:
        ran = {"record", "sky"} | set(cuda_lib.REPLAY_PASSES)
        if not kw.get("enable_clouds", True):
            ran.discard("replay_shade_cloud")
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
@pytest.mark.parametrize("kernel,w,h,steps", [
    ("sky", 67, 131, 2000), ("camera", 67, 131, 2000), ("planes", 67, 131, 2000),
    ("shard", 960, 270, 400),
])
def test_march_kernels_bitwise_at_ragged_shapes(cuda, kernel, w, h, steps):
    """Kernels 4-6 bitwise their plain versions where no dimension is a
    multiple of the 8x4 warp tile: 67x131, and shard (1, 0) of a 4x2 grid
    of the 1920x1080 frame (270 rows) through the plane kernel."""
    if kernel != "shard":
        k, p = _march_both(cuda, kernel, w=w, h=h, steps=steps)
    else:
        scal = pc.pack_camera_scalars(camera_state_from_pose(*HEAD), CameraEffects(), 10.0)
        o, d = rays_from_scalars(scal, w, h, cuda, origin=(0.0, 270.0), img_w=1920, img_h=1080)
        scene = SceneConfig(max_steps=steps)
        k = pm._march_planes_cuda(scene, o, d, 10.0, steps)
        p = pm._march_plain(scene, o, d, 10.0, steps)
    for got, want in zip(_flat(k), _flat(p)):
        assert torch.equal(got, want)


def _flat(out):
    """A fused march's outputs as a list of tensors (Vec3s unpacked)."""
    return [t for a in out for t in (list(a) if isinstance(a, Vec3) else [a])]


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", ["sky", "camera", "planes"])
def test_march_back_to_back_launches_agree(cuda, kernel):
    """Two launches on one stream, each with its own tile order, give the
    same outputs: nothing carries over from one launch to the next."""
    lib = cuda_lib.kernels()
    lib.reset_launches()
    a, _ = _march_both(cuda, kernel, w=64, h=36, steps=400)
    b, _ = _march_both(cuda, kernel, w=64, h=36, steps=400)
    for x, y in zip(_flat(a), _flat(b)):
        assert torch.equal(x, y)
    name = {"sky": "march_sky", "camera": "march_camera", "planes": "march_planes"}[kernel]
    assert lib.launches[name] == 2


@pytest.mark.gpu
def test_march_tile_keys_match_plain(cuda):
    """The order-key kernel against its plain twin (camera and plane rays;
    a key may differ by 1 where powf and torch.pow round apart), and the
    launch order it gives is a permutation of the tiles."""
    lib = cuda_lib.kernels()
    scene = SceneConfig()
    scal = pc.pack_camera_scalars(camera_state_from_pose(*HEAD), CameraEffects(), 1.0)
    w, h = 67, 131
    o, d = rays_from_scalars(scal, w, h, cuda)
    consts, stream = cuda_lib.scene_consts(scene), cuda_lib.current_stream(cuda)
    rays = torch.stack(list(o) + list(d))
    want = cuda_lib.tile_keys_plain(consts, o, d, 2000)
    for got in (lib.tile_keys(consts, cuda_lib.cam_scalars(scal), None, w, h, 2000, stream),
                lib.tile_keys(consts, None, rays, w, h, 2000, stream)):
        assert int((got - want).abs().max()) <= 1
    order = lib.march_order(consts, None, rays, w, h, 2000, stream)
    assert torch.equal(order.cpu(), cuda_lib.order_from_keys(got.cpu()))
    assert torch.equal(torch.sort(order.long()).values,
                       torch.arange(cuda_lib.tile_count(w, h), device=cuda))


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


@pytest.mark.gpu
@pytest.mark.parametrize("ca", [0.0, 1.0], ids=["ca_off", "ca_on"])
def test_tile_background_on_the_card_equals_sample_sky_fast(cuda, ca):
    """The shard plane tile's sky (coordinates + the sky kernel, one
    launch) is bitwise the torch gather it replaced, on a plane march's
    final velocities."""
    eff = CameraEffects(use_chromatic_aberration=ca, ca_amount=0.004)
    sky = skybox_from_array(SKY, cuda)
    scal = pc.pack_camera_scalars(camera_state_from_pose(*HEAD), eff, 10.0)
    origin, direction = rays_from_scalars(scal, 96, 56, cuda)
    _, _, _, vel = pm.march_pallas(SceneConfig(), origin, direction, 10.0, 2000)
    lib = cuda_lib.kernels()
    lib.reset_launches()
    got = tile_background(sky, vel, eff)
    assert lib.launches["sky"] == 1
    want = sample_sky_fast(sky, normalize(vel), eff)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


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
        # the adaptive step sizes and h / 6: float32 products and quotients,
        # as render/march.adaptive_h and physics/integrators.rk4_step make them
        r2 = torch.tensor([1.0, 400.0, 400.0, 400.0])  # near the hole, then not
        zd = torch.tensor([False, True, False, False])
        zc = torch.tensor([False, False, True, False])
        h = adaptive_h(scene, r2, zd, zc, torch.ones(4, dtype=torch.bool))
        assert [c.h_near, c.h_disk, c.h_cloud, c.h_far] == h.tolist()
        assert [c.h6_near, c.h6_disk, c.h6_cloud, c.h6_far] == fdiv(h, 6.0).tolist()
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


@pytest.mark.gpu
@pytest.mark.parametrize("op", ["fma", "mul", "mul_bf16", "rsqrt", "exp"])
def test_chain_kernel_matches_plain(cuda, op):
    """The probe chains against their torch loop on the card, over the
    tool's ITERS x 32 ops a chain: bitwise for fma, mul and mul_bf16 (one
    correctly rounded op each; the loop's fma rounds once from float64);
    rtol 1e-5 for rsqrt (MUFU's approximation against torch's) and exp."""
    from relativisticraytracer_tpu_torch.tools import roofline as rf

    x = rf.chain_input(op, cuda)
    got = rf.chain(op, rf.ITERS, x, 3)
    want = rf.chain_plain(op, rf.ITERS, x, 3)
    if op in ("fma", "mul", "mul_bf16"):
        assert torch.equal(got, want)
    else:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("s", [8, 16, 32, 64])
def test_take_along_kernel_bitwise_gather(cuda, s):
    from relativisticraytracer_tpu_torch.tools import sky_primitives as sp

    tab, idx = sp.inputs(s, 37, cuda, seed=s)
    assert torch.equal(sp.take_along(tab, idx), sp.take_along_plain(tab, idx))


@pytest.mark.gpu
@pytest.mark.parametrize("transfer", ["rgba", "yuv420p"])
def test_animation_job_on_the_card_is_render_np(cuda, tmp_path, monkeypatch, transfer):
    """A 64x48 job on the card (pinned copies, events) writes exactly the
    frames render_np returns, or their YUV420 bytes."""
    from relativisticraytracer_tpu_torch.paths import default_paths, interpolate_path
    from relativisticraytracer_tpu_torch.render.postfx import yuv420_from_rgba8
    from relativisticraytracer_tpu_torch.runtime.app import AnimationJob

    monkeypatch.setattr("relativisticraytracer_tpu_torch.io.video.ffmpeg_available",
                        lambda: False)
    r = Renderer(SceneConfig(max_steps=400), RenderSettings(width=64, height=48, max_steps=400),
                 skybox_rgba=SKY, device=cuda)
    path = default_paths()[0]
    stats = AnimationJob(path=path, renderer=r, fps=4, duration=1.5, transfer=transfer,
                         out_path=str(tmp_path / "clip.mp4")).run()
    want = []
    for k in range(6):
        t = (k + 1) / 4
        frame = r.render(camera_state_from_pose(*interpolate_path(path, t)), None, t)
        if transfer == "yuv420p":
            frame = yuv420_from_rgba8(frame)
        want.append(frame.cpu().numpy().tobytes())
    assert stats["frames_written"] == 6
    assert pathlib.Path(stats["out_path"]).read_bytes() == b"".join(want)
