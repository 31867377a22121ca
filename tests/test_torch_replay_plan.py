"""PyTorch port: the replay's bookkeeping built on the device
(ops/pallas_compact.replay_plan) and its step-list capacity, on CPU tensors.

The plan takes the place of a host-side list (`nonzero` + a stable argsort,
then the step count read on the host), so that the compact frame never
waits for the device. Held here:
- the list order is the host-side list's (longest replay first, ties in
  pixel order), on records, on planes full of ties and on empty frames;
- offsets, the step count and the capacity split (the rays whose steps fit
  are a prefix of the list) against step_lengths / step_offsets;
- the CPU replay runs the kernels' split (the passes' twins over the step
  list of the rays that fit, `_replay_plain` for the rest): a forced small
  capacity (1 step: every ray past the list, bitwise the plain replay;
  half the steps: a real split) gives the unforced (I, T), and the frame
  matches the JAX package's at the pipeline tests' tolerance;
- the plain twins of the split: the step list of the rays that fit is
  bitwise the unforced list's prefix, and so is their composite.

Where a split moves rays between the passes and the per-ray replay, the
comparison carries rtol 1e-6 / atol 1e-7: torch's CPU pow uses SIMD code on
whole vectors and scalar code on the tail, so a ray's last ulp follows its
place in the batch (tests/test_torch_replay_passes.py). A wrong offset,
count or capacity split moves whole steps, far past that."""

import pathlib

import numpy as np
import pytest
import torch

from relativisticraytracer_tpu.config import CameraEffects as JEffects
from relativisticraytracer_tpu.config import RenderSettings as JSettings
from relativisticraytracer_tpu.config import SceneConfig as JScene
from relativisticraytracer_tpu.render import camera as jcam
from relativisticraytracer_tpu.render.pipeline import Renderer as JRenderer
from relativisticraytracer_tpu_torch.config import CameraEffects as TEffects
from relativisticraytracer_tpu_torch.config import RenderSettings as TSettings
from relativisticraytracer_tpu_torch.config import SceneConfig as TScene
from relativisticraytracer_tpu_torch.ops import pallas_compact as pc
from relativisticraytracer_tpu_torch.render import camera as tcam
from relativisticraytracer_tpu_torch.render.pipeline import Renderer
from relativisticraytracer_tpu_torch.render.skybox import skybox_from_array

torch.set_num_threads(2)

POSE = ((0.0, 1.5, -30.0), 0.0, -2.0)
STEPS, T, SKY = 400, 2.0, (64, 128)
W, H = 64, 48


def _scene():
    return TScene(max_steps=STEPS, step_size_m=2.0)


@pytest.fixture(scope="module")
def record():
    cam = tcam.camera_state_from_pose(*POSE)
    return pc.march_pallas_camera_sky_record(_scene(), cam, TEffects(), T, W, H, STEPS, *SKY,
                                             device="cpu")


def _host_list(total):
    """The host-side list the plan replaces: the rays with a replay,
    longest first, ties in pixel order (`nonzero` + a stable argsort)."""
    flat = total.reshape(-1)
    idx = torch.nonzero(flat > 0.0).squeeze(1)
    order = torch.argsort(flat[idx], descending=True, stable=True)
    return idx[order], int(flat.to(torch.int64).sum())


def _planes(record):
    rng = np.random.default_rng(17)
    return {
        "record": record.total,
        "ties": torch.from_numpy(rng.integers(0, 6, (H, W)).astype(np.float32)),
        "all_zero": torch.zeros(H, W),
        "one_ray": torch.zeros(H, W).index_put_((torch.tensor(7), torch.tensor(9)),
                                                torch.tensor(3.0)),
    }


@pytest.mark.parametrize("case", ["record", "ties", "all_zero", "one_ray"])
def test_plan_order_is_the_host_list_order(record, case):
    total = _planes(record)[case]
    plan = pc.replay_plan(total, capacity=1 << 30)
    want, n_steps = _host_list(total)
    m, m_c, s, s_c = plan.counts.tolist()
    assert (m, m_c, s, s_c) == (want.numel(), want.numel(), n_steps, n_steps)
    assert plan.order.dtype == torch.int32 and plan.order.numel() == total.numel()
    assert torch.equal(plan.order[:m].long(), want)
    # the rays with no replay follow, in pixel order
    rest = plan.order[m:].long()
    assert torch.equal(rest, torch.sort(rest).values)
    assert (total.reshape(-1)[rest] == 0).all()
    assert torch.equal(pc.replay_order(total).long(), want)
    if case == "ties":
        assert (total.reshape(-1)[want][1:] == total.reshape(-1)[want][:-1]).any()


@pytest.mark.parametrize("sorted_order", [True, False])
def test_plan_offsets_counts_and_capacity_split(record, sorted_order):
    """Offsets are step_offsets of step_lengths along the list; S is their
    sum; the rays whose steps end within the capacity are the prefix m_c,
    holding S_c steps."""
    order = None if sorted_order else torch.arange(W * H, dtype=torch.int32)
    plan = pc.replay_plan(record.total, 1 << 30, order)
    lengths = pc.step_lengths(record.rec, plan.order)
    assert torch.equal(plan.offsets, pc.step_offsets(lengths))
    n_steps = int(lengths.sum())
    m = int(plan.counts[0])
    assert m == (int((lengths > 0).sum()) if sorted_order else W * H)
    ends = (plan.offsets + lengths).tolist()
    for cap in (1, n_steps // 3, n_steps // 2, n_steps - 1, n_steps, 10 * n_steps):
        split = pc.replay_plan(record.total, cap, order)
        assert torch.equal(split.order, plan.order) and torch.equal(split.offsets, plan.offsets)
        m_c = next((j for j in range(m) if ends[j] > cap), m)
        assert split.counts.tolist() == [m, m_c, n_steps, ends[m_c - 1] if m_c else 0]
        assert split.capacity == cap


def test_step_capacity():
    """STEPS_PER_PIXEL entries a pixel, at most max_steps a pixel: the
    list grows with the frame, so a small frame allocates a small list."""
    assert pc.STEPS_PER_PIXEL == 64
    assert pc.step_capacity(1920 * 1080) == 132_710_400
    assert pc.step_capacity(1920 * 1080, max_steps=2000) == 132_710_400
    assert pc.step_capacity(480 * 272, max_steps=600) == 480 * 272 * 64
    assert pc.step_capacity(64 * 48, max_steps=16) == 64 * 48 * 16  # what a ray can need
    assert pc.step_capacity(0) == 1
    # a 4x2 grid's shards: their lists add up to the frame's
    assert 8 * pc.step_capacity(480 * 540, 2000) == pc.step_capacity(1920 * 1080, 2000)


@pytest.fixture(scope="module")
def plain_replay(record):
    """The plain replay of the listed rays, (I [3, m], T [m]) in list order."""
    sel = _host_list(record.total)[0]
    return sel, pc._replay_plain(_scene(), record.rec, T, sel)


@pytest.mark.parametrize("capacity", ["one step", "half"])
@pytest.mark.parametrize("sorted_order", [True, False])
def test_forced_capacity_replay_matches_unforced(record, plain_replay, capacity, sorted_order):
    """A step list too small for the frame replays the unforced (I, T).
    At one step every listed ray is past the list: bitwise the plain
    replay, the rest I = 0, T = 1. At half the steps the rays that fit go
    through the passes' twins and the rest one ray at a time: the unforced
    replay (every ray in the list) and the plain replay up to the CPU's
    batch-dependent last ulp."""
    scene = _scene()
    sel, (ip, tp) = plain_replay
    n_steps = _host_list(record.total)[1]
    cap = 1 if capacity == "one step" else n_steps // 2
    plan = pc.replay_plan(record.total, cap)
    m, m_c, _, s_c = plan.counts.tolist()
    assert m_c < m and s_c <= cap  # some rays are past the capacity
    if capacity == "half":
        assert 0 < m_c
    if sorted_order:
        replay = lambda c: pc.media_replay_sorted(scene, record, T, capacity=c)  # noqa: E731
    else:
        replay = lambda c: pc.media_replay(scene, record.rec, T, capacity=c)  # noqa: E731
    unforced = pc.replay_plan(record.total, pc.step_capacity(W * H, STEPS)).counts.tolist()
    assert unforced[1] == unforced[0]  # every ray fits the default list
    got = [torch.cat([torch.stack(list(i)).reshape(3, -1), t.reshape(1, -1)])
           for i, t in (replay(cap), replay(None))]
    want = torch.cat([torch.zeros(3, W * H).index_copy_(1, sel, ip),
                      torch.ones(1, W * H).index_copy_(1, sel, tp[None])])
    if capacity == "one step":
        assert torch.equal(got[0], want)
    for ref in (got[1], want):
        np.testing.assert_allclose(got[0].numpy(), ref.numpy(), rtol=1e-6, atol=1e-7)


def test_split_plain_twins(record):
    """The kernels' split with their plain twins: the march pass writes the
    rays that fit (the first m_c) into a list of S_c entries, bitwise the
    unforced list's prefix (no transcendental on the way); their composite
    is bitwise the unforced one; the rest replay one ray at a time
    (`_replay_plain`, the per-ray kernel's twin) to the whole list's plain
    replay up to the batch-dependent last ulp."""
    scene = _scene()
    full = pc.replay_plan(record.total, 1 << 30)
    m, _, n_steps, _ = full.counts.tolist()
    sel, offsets = full.order[:m].long(), full.offsets[:m]
    pos, vel = pc._replay_march_plain(scene, record.rec, sel, offsets, n_steps)
    emit = pc._replay_shade_plain(scene, pos, vel, T)
    i_full, t_full = pc._replay_composite_plain(emit, offsets)

    split = pc.replay_plan(record.total, n_steps // 2)
    _, m_c, _, s_c = split.counts.tolist()
    assert 0 < m_c < m and 0 < s_c <= n_steps // 2
    pos_c, vel_c = pc._replay_march_plain(scene, record.rec, sel[:m_c], offsets[:m_c], s_c)
    assert torch.equal(pos_c, pos[:s_c]) and torch.equal(vel_c, vel[:s_c])
    i_c, t_c = pc._replay_composite_plain(emit[:s_c], offsets[:m_c])
    assert torch.equal(i_c, i_full[:, :m_c]) and torch.equal(t_c, t_full[:m_c])

    i_o, t_o = pc._replay_plain(scene, record.rec, T, sel[m_c:])
    i_all, t_all = pc._replay_plain(scene, record.rec, T, sel)
    np.testing.assert_allclose(i_o.numpy(), i_all[:, m_c:].numpy(), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(t_o.numpy(), t_all[m_c:].numpy(), rtol=1e-6, atol=1e-7)


def test_compact_frame_at_a_small_capacity_matches_jax(monkeypatch):
    """One step a pixel (the step list holds a few of the frame's rays,
    the per-ray replay takes the rest) renders the default frame's bytes,
    and the JAX package's frame within the pipeline tests' gate (RMSE <
    1e-3, bytes within 1 level)."""
    settings = dict(width=48, height=32, max_steps=160)
    pose = ((0.0, 3.0, -30.0), 0.0, -6.0)
    rgba = np.load(pathlib.Path(__file__).resolve().parent / "torch_data"
                   / "starfield_64x128.npy")
    sky = skybox_from_array(rgba, "cpu")
    cam = tcam.camera_state_from_pose(*pose)
    splits = []
    real_plan = pc.replay_plan

    def plan(total, capacity, order=None):
        out = real_plan(total, capacity, order)
        splits.append(out.counts.tolist())
        return out

    monkeypatch.setattr(pc, "replay_plan", plan)
    frames, default = [], pc.STEPS_PER_PIXEL
    for per_pixel in (default, 1):
        monkeypatch.setattr(pc, "STEPS_PER_PIXEL", per_pixel)
        frames.append(Renderer(TScene(max_steps=160), TSettings(**settings), skybox=sky,
                               device="cpu").render_np(cam, TEffects(), 0.5))
    (m, m_c, s, s_c), (m1, m1_c, s1, s1_c) = splits
    assert (m_c, s_c) == (m, s) and s <= 48 * 32 * default  # the default list holds it
    assert 0 < m1_c < m1 and s1_c <= 48 * 32 < s1  # one step a pixel: a real split
    np.testing.assert_array_equal(frames[1], frames[0])
    want = JRenderer(JScene(max_steps=160), JSettings(loop="while", **settings),
                     skybox_rgba=rgba).render_np(jcam.camera_state_from_pose(*pose),
                                                 JEffects(), 0.5)
    d = frames[1][..., :3].astype(np.int64) - want[..., :3].astype(np.int64)
    assert np.sqrt(np.mean((d / 255.0) ** 2)) < 1e-3
    assert np.abs(d).max() <= 1


def test_replay_traffic_tool_counts_the_host_list():
    """tools/replay_traffic.py on CPU tensors: each sampled frame's m and S
    are the host-side list's, its density S / pixels, its rays past the
    step list none at 64 steps a pixel and the plan's at 1 (a real split);
    the summary has one line a path; the tool needs a card."""
    from relativisticraytracer_tpu_torch.paths import default_paths, interpolate_path
    from relativisticraytracer_tpu_torch.tools import replay_traffic as rt

    rows = rt.survey(sizes=[("tiny", 24, 16)], every=15.0, device="cpu", max_steps=120)
    paths = {p.name: p for p in default_paths()}
    assert [(r["path"], r["time"]) for r in rows] == [
        (name, t) for name, p in paths.items() for t in (0.0, 15.0, 30.0)
        if t <= p.keyframes[-1].time]
    for r in rows:
        cam = tcam.camera_state_from_pose(*interpolate_path(paths[r["path"]], r["time"]))
        record = pc.march_pallas_camera_sky_record(TScene(), cam, TEffects(), r["time"], 24, 16,
                                                   120, *rt.SKY_SHAPE, device="cpu")
        want, n_steps = _host_list(record.total)
        assert (r["rays"], r["steps"], r["pixels"]) == (want.numel(), n_steps, 24 * 16)
        assert r["density"] == n_steps / (24 * 16) and r["capacity"] == 24 * 16 * 64
        assert (r["rays_past"], r["steps_past"]) == (0, 0)
        m, m_c, s, s_c = pc.replay_plan(record.total, 24 * 16).counts.tolist()
        if s > 24 * 16:
            assert 0 < m - m_c and s_c <= 24 * 16
    assert len(rt.summary(rows)) == 3
    assert any(r["steps"] > 24 * 16 for r in rows)  # a frame that one step a pixel splits
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit):
            rt.main([])
