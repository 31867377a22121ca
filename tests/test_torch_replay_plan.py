"""PyTorch port: the replay's bookkeeping built on the device
(ops/pallas_compact.replay_plan) and its step-list capacity, on CPU tensors.

The plan takes the place of a host-side list (`nonzero` + a stable argsort,
then the step count read on the host), so that the compact frame never
waits for the device. Held here:
- the list order is the host-side list's (longest replay first, ties in
  pixel order), on records, on planes full of ties and on empty frames;
- offsets, the step count and the counts of the rounds against
  step_lengths / step_offsets (the round table itself:
  tests/test_torch_replay_rounds.py);
- the step list's budget and the rounds a frame can need;
- the CPU replay runs the kernels' split (the passes' twins, round by
  round over the step list, `_replay_plain` for the rest): a forced small
  capacity (1 step: the rays longer than the list go to the per-ray
  replay; half the steps: the passes in rounds) gives the unforced (I, T),
  and the frame matches the JAX package's at the pipeline tests' tolerance;
- the plain twins of the split: each round's step list is bitwise the
  unforced list's entries from its base, and so is its rays' composite.

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
    sum. At a capacity below the longest ray the list puts the rays longer
    than it first (the sorted order already does); the rounds take the rest
    up to their number, and the counts are (m, the rounds' rays, S, their
    steps)."""
    order = None if sorted_order else torch.arange(W * H, dtype=torch.int32)
    plan = pc.replay_plan(record.total, 1 << 30, order)
    lengths = pc.step_lengths(record.rec, plan.order)
    assert torch.equal(plan.offsets, pc.step_offsets(lengths))
    n_steps = int(lengths.sum())
    m = int(plan.counts[0])
    assert m == (int((lengths > 0).sum()) if sorted_order else W * H)
    assert plan.rounds.tolist()[0] == [0, m, 0, n_steps]
    for cap in (1, n_steps // 3, n_steps // 2, n_steps - 1, n_steps, 10 * n_steps):
        split = pc.replay_plan(record.total, cap, order)
        longer = (lengths[:m] > cap).tolist()
        if sorted_order:
            assert torch.equal(split.order, plan.order)
        else:  # the rays longer than the list first, each part in image order
            want = [j for j, x in enumerate(longer) if x] + [j for j, x in enumerate(longer) if not x]
            assert split.order.tolist() == want
        split_lengths = pc.step_lengths(record.rec, split.order)
        assert torch.equal(split.offsets, pc.step_offsets(split_lengths))
        table = split.rounds.tolist()
        assert table[0][0] == sum(longer)
        assert split.counts.tolist() == [m, sum(r[1] for r in table), n_steps,
                                         sum(r[3] for r in table)]
        assert all(r[3] <= cap for r in table) and split.capacity == cap


def test_step_capacity():
    """What the frame can need (max_steps a pixel), at most STEP_BUDGET
    entries: a frame of any size allocates at most 2^27 entries (5.4 GB),
    a small frame what its rays can need; a shard at most the budget."""
    assert pc.STEP_BUDGET == 1 << 27 >= 1920 * 1080 * 64  # a 1080p list of 64 steps a pixel
    assert pc.step_capacity(1920 * 1080) == pc.STEP_BUDGET
    assert pc.step_capacity(1920 * 1080, max_steps=2000) == pc.STEP_BUDGET
    assert pc.step_capacity(3840 * 2160, max_steps=2000) == pc.STEP_BUDGET
    assert pc.step_capacity(7680 * 4320, max_steps=2000) == pc.STEP_BUDGET
    assert pc.step_capacity(480 * 272, max_steps=600) == 480 * 272 * 600
    assert pc.step_capacity(480 * 272, max_steps=2000) == pc.STEP_BUDGET
    assert pc.step_capacity(64 * 48, max_steps=16) == 64 * 48 * 16  # what a ray can need
    assert pc.step_capacity(0) == 1
    # a 4x2 grid's shards: each at most the budget
    assert pc.step_capacity(480 * 540, 2000) == pc.STEP_BUDGET
    assert 40 * pc.step_capacity(7680 * 4320, 2000) <= 5.4e9  # bytes of the list


@pytest.fixture(scope="module")
def plain_replay(record):
    """The plain replay of the listed rays, (I [3, m], T [m]) in list order."""
    sel = _host_list(record.total)[0]
    return sel, pc._replay_plain(_scene(), record.rec, T, sel)


@pytest.mark.parametrize("capacity", ["one step", "half"])
@pytest.mark.parametrize("sorted_order", [True, False])
def test_forced_capacity_replay_matches_unforced(record, plain_replay, capacity, sorted_order):
    """A step list too small for the frame replays the unforced (I, T).
    At one step the rays longer than the list go one ray at a time, and the
    rounds take a ray of one step each: the plain replay, the rest I = 0,
    T = 1; the per-ray rays bitwise the plain replay of those rays. At half
    the steps the passes' twins run in rounds and take every ray. Against
    the unforced replay (every ray in one list) and the plain replay of
    every ray: up to the CPU's batch-dependent last ulp."""
    scene = _scene()
    sel, (ip, tp) = plain_replay
    n_steps = _host_list(record.total)[1]
    cap = 1 if capacity == "one step" else n_steps // 2
    plan = pc.replay_plan(record.total, cap)
    m, m_r, _, s_r = plan.counts.tolist()
    used = [r for r in plan.rounds.tolist() if r[1]]
    assert all(r[3] <= cap for r in used)
    if capacity == "one step":
        assert m_r < m and plan.rounds[0, 0] > 0  # rays longer than the list
    else:
        assert (m_r, s_r) == (m, n_steps) and len(used) >= 2  # every ray in the rounds
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
    if capacity == "one step":  # the per-ray replay's rays: bitwise its twin on them
        table = plan.rounds.tolist()
        past = torch.cat([plan.order[:table[0][0]],
                          plan.order[table[-1][0] + table[-1][1]:m]]).long()
        pi, pt = pc._replay_plain(scene, record.rec, T, past)
        assert torch.equal(got[0][:3, past], pi) and torch.equal(got[0][3, past], pt)
    for ref in (got[1], want):
        np.testing.assert_allclose(got[0].numpy(), ref.numpy(), rtol=1e-6, atol=1e-7)


def test_split_plain_twins(record):
    """The kernels' split with their plain twins: at half the steps the
    march pass writes each round's rays into a list of its steps, bitwise
    the unforced list's entries from the round's base (no transcendental
    on the way); their composite is bitwise the unforced one; rays the
    rounds do not take replay one ray at a time (`_replay_plain`, the
    per-ray kernel's twin) to the whole list's plain replay up to the
    batch-dependent last ulp."""
    scene = _scene()
    full = pc.replay_plan(record.total, 1 << 30)
    m, _, n_steps, _ = full.counts.tolist()
    sel, offsets = full.order[:m].long(), full.offsets[:m]
    pos, vel = pc._replay_march_plain(scene, record.rec, sel, offsets, n_steps)
    emit = pc._replay_shade_plain(scene, pos, vel, T)
    i_full, t_full = pc._replay_composite_plain(emit, offsets)

    split = pc.replay_plan(record.total, n_steps // 2)
    assert torch.equal(split.order, full.order) and torch.equal(split.offsets, full.offsets)
    used = [r for r in split.rounds.tolist() if r[1]]
    assert len(used) >= 2 and used[0][0] == 0
    for first, rays, base, steps in used:
        assert 0 < steps <= n_steps // 2
        part = slice(first, first + rays)
        pos_r, vel_r = pc._replay_march_plain(scene, record.rec, sel[part],
                                              offsets[part] - base, steps)
        assert torch.equal(pos_r, pos[base:base + steps])
        assert torch.equal(vel_r, vel[base:base + steps])
        i_r, t_r = pc._replay_composite_plain(emit[base:base + steps], offsets[part] - base)
        assert torch.equal(i_r, i_full[:, part]) and torch.equal(t_r, t_full[part])

    # a capacity of the longest ray: the rounds take a few, the rest go one ray at a time
    short = pc.replay_plan(record.total, int(pc.step_lengths(record.rec, sel).max()))
    past = short.rounds[-1, 0] + short.rounds[-1, 1]
    assert short.rounds[0, 0] == 0 and past < m
    i_o, t_o = pc._replay_plain(scene, record.rec, T, sel[past:])
    i_all, t_all = pc._replay_plain(scene, record.rec, T, sel)
    np.testing.assert_allclose(i_o.numpy(), i_all[:, past:].numpy(), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(t_o.numpy(), t_all[past:].numpy(), rtol=1e-6, atol=1e-7)


def test_compact_frame_at_a_small_capacity_matches_jax(monkeypatch):
    """A budget of one step a pixel (each round's step list holds a few of
    the frame's rays, the per-ray replay takes those past the last round)
    renders the default frame's bytes, and the JAX package's frame within
    the pipeline tests' gate (RMSE < 1e-3, bytes within 1 level)."""
    settings = dict(width=48, height=32, max_steps=160)
    pose = ((0.0, 3.0, -30.0), 0.0, -6.0)
    rgba = np.load(pathlib.Path(__file__).resolve().parent / "torch_data"
                   / "starfield_64x128.npy")
    sky = skybox_from_array(rgba, "cpu")
    cam = tcam.camera_state_from_pose(*pose)
    splits = []
    real_plan = pc.replay_plan

    def plan(total, capacity, order=None, rounds=pc.ROUNDS, lib=None):
        out = real_plan(total, capacity, order, rounds, lib)
        splits.append((out.counts.tolist(), out.rounds.tolist()))
        return out

    monkeypatch.setattr(pc, "replay_plan", plan)
    frames = []
    for budget in (pc.STEP_BUDGET, 48 * 32):
        monkeypatch.setattr(pc, "STEP_BUDGET", budget)
        frames.append(Renderer(TScene(max_steps=160), TSettings(**settings), skybox=sky,
                               device="cpu").render_np(cam, TEffects(), 0.5))
    ((m, m_r, s, s_r), table), ((m1, m1_r, s1, s1_r), table1) = splits
    assert (m_r, s_r) == (m, s) and len(table) == 1  # the default list holds it in one round
    assert s1 > 48 * 32 and len(table1) == pc.ROUNDS and all(r[3] <= 48 * 32 for r in table1)
    assert 0 < m1_r < m1  # one step a pixel: rounds, and rays past them
    np.testing.assert_array_equal(frames[1], frames[0])
    want = JRenderer(JScene(max_steps=160), JSettings(loop="while", **settings),
                     skybox_rgba=rgba).render_np(jcam.camera_state_from_pose(*pose),
                                                 JEffects(), 0.5)
    d = frames[1][..., :3].astype(np.int64) - want[..., :3].astype(np.int64)
    assert np.sqrt(np.mean((d / 255.0) ** 2)) < 1e-3
    assert np.abs(d).max() <= 1


def test_replay_traffic_tool_counts_the_host_list():
    """tools/replay_traffic.py on CPU tensors: each sampled frame's m and S
    are the host-side list's, its density S / pixels, its capacity what
    its rays can need, one round and no ray past it; the plan's rounds at a
    list of an eighth of a step a pixel (`small`) leave rays past them (a real
    split); the summary has one line a path; the tool needs a card."""
    from relativisticraytracer_tpu_torch.paths import default_paths, interpolate_path
    from relativisticraytracer_tpu_torch.tools import replay_traffic as rt

    small = 24 * 16 // 8
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
        assert r["density"] == n_steps / (24 * 16) and r["capacity"] == 24 * 16 * 120
        assert (r["rounds"], r["rounds_used"], r["rays_past"], r["steps_past"]) == (
            1, 1 if n_steps else 0, 0, 0)
        m, m_r, s, s_r = pc.replay_plan(record.total, small).counts.tolist()
        if s > pc.ROUNDS * small:
            assert 0 < m - m_r and s_r <= pc.ROUNDS * small
    assert len(rt.summary(rows)) == 3
    assert rt.totals(rows)["tiny"]["frames"] == len(rows)
    # a frame that a list of `small` entries leaves rays past the rounds of
    assert any(r["steps"] > pc.ROUNDS * small for r in rows)
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit):
            rt.main([])
