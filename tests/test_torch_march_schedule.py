"""PyTorch port: the fused march's launch schedule (csrc/march.cu) in its
plain twins on the CPU — the tile map that turns a warp's tile into
pixels, and the straight-line step estimate that orders the tiles longest
first.

The tile map must cover every pixel of a launch exactly once, ragged
edges included, whatever order the tiles are launched in: a ray's pixel
never depends on which warp marches it. The order key is never part of a
ray's values; it only has to rank tiles like their true step counts. The
kernels themselves are held to their plain versions on the card
(tests/test_torch_kernels_gpu.py, chip_smoke.py)."""

import pathlib
import re

import numpy as np
import pytest
import torch

from relativisticraytracer_tpu_torch.config import CameraEffects, SceneConfig
from relativisticraytracer_tpu_torch.core.vecmath import Vec3
from relativisticraytracer_tpu_torch.ops import cuda_lib
from relativisticraytracer_tpu_torch.ops import pallas_compact as pc
from relativisticraytracer_tpu_torch.ops.camera_rays import rays_from_scalars
from relativisticraytracer_tpu_torch.parallel.sharding import _interleave_strips_ss
from relativisticraytracer_tpu_torch.render import march as rm
from relativisticraytracer_tpu_torch.render.camera import camera_state_from_pose

torch.set_num_threads(2)

MARCH_CU = (pathlib.Path(cuda_lib.__file__).resolve().parent.parent / "csrc" / "march.cu")
HEAD = ((0.0, 10.0, -60.0), 0.0, -10.0)


def _coverage(width, height, order=None):
    """How many lanes render each local pixel when the tiles run in
    `order` (None: every tile once, row-major)."""
    x, y, inside = cuda_lib.tile_map(width, height)
    if order is not None:
        x, y, inside = x[order], y[order], inside[order]
    count = np.zeros((height, width), np.int64)
    np.add.at(count, (y[inside], x[inside]), 1)
    return count


@pytest.mark.parametrize("width,height", [(64, 48), (192, 108), (960, 270), (67, 131),
                                          (1920, 1080)])
def test_tile_map_covers_every_pixel_once(width, height):
    """Ragged shapes too: 108, 131 and 270 rows are no multiple of the
    tile height, 67 columns no multiple of its width."""
    assert cuda_lib.tile_count(width, height) == len(cuda_lib.tile_map(width, height)[0])
    assert (_coverage(width, height) == 1).all()
    order = np.random.default_rng(0).permutation(cuda_lib.tile_count(width, height))
    assert (_coverage(width, height, order) == 1).all()


def test_tile_map_is_the_kernels():
    """The twin's tile shape is the one csrc/march.cu launches, and one warp
    (32 lanes) renders a tile."""
    src = MARCH_CU.read_text()
    m = re.search(r"constexpr int TILE_W = (\d+), TILE_H = (\d+);", src)
    assert m, "csrc/march.cu no longer states its tile shape"
    assert (int(m.group(1)), int(m.group(2))) == (cuda_lib.TILE_W, cuda_lib.TILE_H)
    assert cuda_lib.TILE_W * cuda_lib.TILE_H == 32
    x, y, _ = cuda_lib.tile_map(16, 8)
    assert (x[0] == np.arange(32) % cuda_lib.TILE_W).all()
    assert (y[0] == np.arange(32) // cuda_lib.TILE_W).all()
    assert x[1].min() == cuda_lib.TILE_W and y[2].min() == cuda_lib.TILE_H


def test_strip_mapped_shards_cover_the_frame_once():
    """A strip-interleaved 4x2 grid: each shard's tiles map through the
    shard's strip map (march_common.cuh::gen_ray's RayGrid) into the
    frame, and together they cover every frame pixel once."""
    ny, nx, width, height = 4, 2, 192, 112
    sh, _ = _interleave_strips_ss(height, width, ny, nx, 1)
    th, tw = height // ny, width // nx
    count = np.zeros((height, width), np.int64)
    for i in range(ny):
        for j in range(nx):
            x, y, inside = cuda_lib.tile_map(tw, th)
            ly, lx = y[inside], x[inside]
            gy = i * sh + (ly // sh) * (ny * sh) + ly % sh
            np.add.at(count, (gy, j * tw + lx), 1)
    assert sh and (count == 1).all()


def test_straight_line_cost_of_rays_through_the_hole_and_the_disk():
    """A ray from z = -60 straight at the hole in the disk plane: captured
    at the centre (t = 60): 18 units near the hole (h_near 0.03), 12 in
    the disk zone outside them (h_disk 0.09), 30 far (h_far 0.3) —
    100 + 133.3 + 600 steps; a ray far above the zones runs to r = 250.
    A ray that crosses the disk annulus costs more with the media on, by
    its steps in the probes' slabs times their extra work."""
    def cost(scene, o, d, cap=2000):
        planes = [torch.tensor([[c]], dtype=torch.float32) for c in o + d]
        return int(cuda_lib.straight_line_cost(cuda_lib.scene_consts(scene), planes[:3],
                                               planes[3:], cap))

    full, vacuum = SceneConfig(), SceneConfig(enable_disk=False, enable_clouds=False)
    assert abs(cost(full, (0.0, 0.0, -60.0), (0.0, 0.0, 1.0)) - 833) <= 1
    assert cost(full, (0.0, 0.0, -60.0), (0.0, 0.0, 1.0), cap=500) == 500
    far = cost(full, (0.0, 100.0, -60.0), (0.0, 0.0, 1.0))
    assert abs(far - (60.0 + np.sqrt(250.0 ** 2 - 100.0 ** 2)) / 0.3) <= 2
    assert cost(full, (0.0, 0.0, -60.0), (0.0, 0.0, 0.0)) == 2000  # no direction: the cap
    # down through the annulus at r_cyl = 15 (slope 1/4): the disk probe's
    # slab |y| < (k2 / 225)^(1/4) and the cloud zone's |y| < 0.75, each at
    # h_near (r < 18) over the path's |u_y|
    o, d = (15.0, 10.0, -40.0), (0.0, -0.25, 1.0)
    base = cost(vacuum, o, d)
    consts = cuda_lib.scene_consts(full)
    uy = 0.25 / np.sqrt(1.0 + 0.25 ** 2)
    slab_d = min((consts.disk_k2 / 225.0) ** 0.25, consts.disk_zone_y)
    slab_c = min((consts.cloud_k2 / 225.0) ** 0.1, consts.cloud_zone_y)
    extra = 2.0 / (uy * consts.h_near) * (6.0 * slab_d + 21.0 * slab_c)
    assert abs(cost(full, o, d) - (base + extra)) <= 2
    assert cost(SceneConfig(enable_clouds=False), o, d) < cost(full, o, d)


def test_order_puts_expensive_tiles_first_then_row_major():
    """Tiles with a key of at least 1.5x the cheapest go first, then the
    rest, each class in row-major order: a permutation of the tiles."""
    keys = torch.tensor([900, 2000, 950, 1349, 1350, 4000, 900, 1000], dtype=torch.int32)
    order = cuda_lib.order_from_keys(keys)
    assert order.dtype == torch.int32
    assert order.tolist() == [1, 4, 5, 0, 2, 3, 6, 7]
    flat = torch.full((16,), 700, dtype=torch.int32)
    assert cuda_lib.order_from_keys(flat).tolist() == list(range(16))


def test_tile_keys_rank_tiles_like_their_true_cost():
    """At the headline pose (48x27, 2000 steps) the tiles' keys rank them
    as their most expensive ray's true cost in the plain march does (steps,
    plus 6 a disk-probe step and 21 a cloud-probe step), the most expensive
    tile first, and each key is its tile's largest ray estimate."""
    scene = SceneConfig()
    w, h = 48, 27
    scal = pc.pack_camera_scalars(camera_state_from_pose(*HEAD), CameraEffects(), 1.0)
    o, d = rays_from_scalars(scal, w, h, "cpu")
    consts = cuda_lib.scene_consts(scene)
    est = cuda_lib.straight_line_cost(consts, o, d, 2000)
    keys = cuda_lib.tile_keys_plain(consts, o, d, 2000)
    x, y, inside = cuda_lib.tile_map(w, h)
    per_lane = np.where(inside, est.numpy()[np.minimum(y, h - 1), np.minimum(x, w - 1)], 0)
    assert keys.dtype == torch.int32 and (keys.numpy() == per_lane.max(axis=1)).all()
    assert 0 < int(keys.min())

    cost = _true_cost(scene, o, d, 2000).reshape(h, w).numpy()
    true = np.where(inside, cost[np.minimum(y, h - 1), np.minimum(x, w - 1)], 0).max(axis=1)
    rank = lambda a: np.argsort(np.argsort(a, kind="stable"), kind="stable")  # noqa: E731
    rho = np.corrcoef(rank(keys.numpy()), rank(true))[0, 1]
    assert rho > 0.9, rho
    assert true[keys.numpy() == keys.numpy().max()].max() >= np.sort(true)[-3]


def _true_cost(scene, o, d, max_steps):
    """Each ray's cost in the plain march, one masked step at a time: its
    steps, plus 6 for each step whose disk probe is True and 21 for each
    whose cloud probe is (the probes of render/march.media_probes). The
    step sizes follow the zones alone, so the vacuum scene marches the
    full scene's trajectories."""
    vacuum = SceneConfig(enable_disk=False, enable_clouds=False)
    state = rm.init_state(Vec3(*(a.reshape(-1) for a in o)), Vec3(*(a.reshape(-1) for a in d)))
    cost = torch.zeros_like(state.transmittance, dtype=torch.int64)
    t = torch.tensor(1.0)
    for _ in range(max_steps):
        if not bool(state.active.any()):
            break
        rel = state.p
        r2 = rel.x * rel.x + rel.y * rel.y + rel.z * rel.z
        zd, zc = rm.media_zones(scene, rel, r2)
        pd, pc = rm.media_probes(scene, rel, zd, zc, state.active)
        cost += state.active.long() + 6 * pd.long() + 21 * pc.long()
        state = rm.march_step(vacuum, state, t)
    return cost
