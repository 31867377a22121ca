"""PyTorch port: the replay's rounds over its step list
(ops/pallas_compact.replay_plan's round table, `replay_rounds`, and the CPU
replay that runs the passes' twins round by round), on CPU tensors.

The step list has a fixed budget of entries (`STEP_BUDGET`), so a dense
frame's steps do not fit one list: the passes run in rounds, each taking the
next rays whose steps fit the list from the round's base offset, and the
rays longer than the list or past the last round go to the per-ray replay.
Held here:
- the round table against a host-side greedy reference over capacities of
  one step, a few steps, the longest ray, a third of the steps (several
  rounds), exactly the steps and more, in the sorted and the image order,
  and on planes of ties, one ray and no ray;
- the rounds a frame can need (`replay_rounds`) against greedy packing of
  random lengths;
- each round's step list and composite (the twins) bitwise the one list's
  entries from the round's base;
- a forced multi-round replay against the one-list and the plain replay,
  and a compact frame in at least three rounds against the JAX package's.

Rays that move between batches carry rtol 1e-6 / atol 1e-7: torch's CPU
pow rounds an element by its place in the batch
(tests/test_torch_replay_passes.py). On the card the kernels are bitwise
(tests/test_torch_kernels_gpu.py)."""

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


def _greedy(lengths, cap, rounds):
    """Host-side reference of the round table: (order positions, table) for
    the listed rays' `lengths` along the list. The rays longer than `cap`
    go first (they are already first in a longest-first list); then each
    round adds rays, in list order, while its steps stay within `cap`."""
    longer = [j for j, n in enumerate(lengths) if n > cap]
    pos = longer + [j for j, n in enumerate(lengths) if n <= cap]
    lens = [lengths[j] for j in pos]
    offsets = np.concatenate([[0], np.cumsum(lens)]).astype(int).tolist()
    j, table = len(longer), []
    for _ in range(rounds):
        first, steps = j, 0
        while j < len(lens) and steps + lens[j] <= cap:
            steps += lens[j]
            j += 1
        table.append([first, j - first, offsets[first], steps])
    return pos, table


def _planes(record):
    rng = np.random.default_rng(23)
    return {
        "record": record.total,
        "ties": torch.from_numpy(rng.integers(0, 6, (H, W)).astype(np.float32)),
        "all_zero": torch.zeros(H, W),
        "one_ray": torch.zeros(H, W).index_put_((torch.tensor(7), torch.tensor(9)),
                                                torch.tensor(3.0)),
    }


CAPACITIES = ["one step", "a few", "longest ray", "a third", "exact fit", "all fit"]


def _capacity(name, lengths):
    n_steps, longest = int(lengths.sum()), int(lengths.max()) if lengths.numel() else 0
    return max(1, {"one step": 1, "a few": 5, "longest ray": longest, "a third": n_steps // 3,
                   "exact fit": n_steps, "all fit": 10 * n_steps}[name])


@pytest.mark.parametrize("cap_name", CAPACITIES)
@pytest.mark.parametrize("case", ["record", "ties", "all_zero", "one_ray"])
@pytest.mark.parametrize("sorted_order", [True, False])
def test_round_table_matches_the_greedy_reference(record, case, cap_name, sorted_order):
    """The plan's round table and counts are the greedy reference's, its
    order the reference's, its offsets the exclusive prefix sums along it."""
    total = _planes(record)[case]
    flat = total.reshape(-1).to(torch.int64)
    if sorted_order:
        base = pc.replay_plan(total, 1 << 30)
        m = int(base.counts[0])
        listed = base.order[:m].long()
        order = None
    else:
        listed = torch.arange(W * H)
        order = listed.to(torch.int32)
        m = W * H
    lengths = flat[listed]
    cap = _capacity(cap_name, lengths)
    plan = pc.replay_plan(total, cap, order)
    pos, table = _greedy(lengths.tolist(), cap, pc.ROUNDS)
    assert plan.order[:m].long().tolist() == listed[pos].tolist()
    assert plan.rounds.tolist() == table
    assert plan.counts.tolist() == [m, sum(r[1] for r in table), int(lengths.sum()),
                                    sum(r[3] for r in table)]
    assert torch.equal(plan.offsets, pc.step_offsets(flat[plan.order.long()]))
    if cap_name in ("exact fit", "all fit"):
        assert table[0] == [0, m, 0, int(lengths.sum())]
    if cap_name == "exact fit" and case == "record":
        assert table[0][3] == cap  # round 0 fills the list exactly
    if cap_name == "a third" and case == "record":
        assert sum(1 for r in table if r[1]) >= 3


def test_replay_rounds_bounds_greedy_packing():
    """replay_rounds(pixels, max_steps, capacity) rounds hold any frame of
    `pixels` rays of at most max_steps steps: greedy packing of random
    lengths (dense, sparse, all at the cap) never needs more, up to
    ROUNDS; a list that holds every step a frame can need takes one round,
    a list shorter than a ray all the rounds."""
    rng = np.random.default_rng(5)
    for pixels, max_steps in ((500, 40), (3000, 7), (64, 400), (1, 1)):
        for cap in (max_steps, max_steps + 1, 3 * max_steps, pixels * max_steps // 5,
                    pixels * max_steps // 2, pixels * max_steps):
            cap = max(cap, max_steps)
            bound = pc.replay_rounds(pixels, max_steps, cap)
            assert 1 <= bound <= pc.ROUNDS
            for fill in (rng.integers(0, max_steps + 1, pixels),
                         np.where(rng.random(pixels) < 0.1, max_steps, 0),
                         np.full(pixels, max_steps)):
                lengths = sorted(fill.tolist(), reverse=True)
                lengths = [n for n in lengths if n > 0]
                _, table = _greedy(lengths, cap, bound)
                used = sum(r[1] for r in table)
                assert used == len(lengths) or bound == pc.ROUNDS
            if pixels * max_steps <= cap:
                assert bound == 1
    assert pc.replay_rounds(100, 50, 49) == pc.ROUNDS  # a ray longer than the list
    assert pc.replay_rounds(1920 * 1080, 2000, pc.step_capacity(1920 * 1080, 2000)) == pc.ROUNDS
    assert pc.replay_rounds(480 * 272, 600, pc.step_capacity(480 * 272, 600)) == 1
    assert pc.replay_rounds(480 * 272, 2000, pc.step_capacity(480 * 272, 2000)) == 2
    assert pc.replay_rounds(256 * 256, 256, pc.step_capacity(256 * 256, 256)) == 1


def test_round_lists_are_slices_of_the_one_list(record):
    """A third of the steps (at least three rounds): each round's march
    twin writes its rays into a list of its steps bitwise the one list's
    entries from its base, and its composite of those entries is bitwise
    the one list's composite of its rays."""
    scene = _scene()
    full = pc.replay_plan(record.total, 1 << 30)
    m, _, n_steps, _ = full.counts.tolist()
    sel, offsets = full.order[:m].long(), full.offsets[:m]
    pos, vel = pc._replay_march_plain(scene, record.rec, sel, offsets, n_steps)
    emit = pc._replay_shade_plain(scene, pos, vel, T)
    i_full, t_full = pc._replay_composite_plain(emit, offsets)
    plan = pc.replay_plan(record.total, n_steps // 3)
    used = [r for r in plan.rounds.tolist() if r[1]]
    assert len(used) >= 3 and plan.counts.tolist()[1] == m
    for first, rays, base, steps in used:
        part = slice(first, first + rays)
        pos_r, vel_r = pc._replay_march_plain(scene, record.rec, sel[part],
                                              offsets[part] - base, steps)
        assert torch.equal(pos_r, pos[base:base + steps])
        assert torch.equal(vel_r, vel[base:base + steps])
        i_r, t_r = pc._replay_composite_plain(emit[base:base + steps], offsets[part] - base)
        assert torch.equal(i_r, i_full[:, part]) and torch.equal(t_r, t_full[part])


@pytest.mark.parametrize("sorted_order", [True, False])
def test_forced_multi_round_replay_matches_one_list_and_plain(record, sorted_order):
    """At a third of the steps the CPU replay runs the passes' twins in at
    least three rounds and takes every ray: the one-list replay's (I, T)
    and the plain replay's, up to the CPU's batch-dependent last ulp; the
    pixels with no replay keep I = 0, T = 1."""
    scene = _scene()
    full = pc.replay_plan(record.total, 1 << 30)
    m, _, n_steps, _ = full.counts.tolist()
    sel = full.order[:m].long()
    cap = n_steps // 3
    plan = pc.replay_plan(record.total, cap, None if sorted_order else
                          torch.arange(W * H, dtype=torch.int32))
    assert sum(1 for r in plan.rounds.tolist() if r[1]) >= 3
    assert plan.counts[1] == plan.counts[0]  # the rounds take every ray
    if sorted_order:
        replay = lambda c: pc.media_replay_sorted(scene, record, T, capacity=c)  # noqa: E731
    else:
        replay = lambda c: pc.media_replay(scene, record.rec, T, capacity=c)  # noqa: E731
    got, one = ([torch.cat([torch.stack(list(i)).reshape(3, -1), t.reshape(1, -1)])
                 for i, t in (replay(cap), replay(1 << 30))])
    ip, tp = pc._replay_plain(scene, record.rec, T, sel)
    want = torch.cat([torch.zeros(3, W * H).index_copy_(1, sel, ip),
                      torch.ones(1, W * H).index_copy_(1, sel, tp[None])])
    rest = torch.ones(W * H, dtype=torch.bool).index_fill_(0, sel, False)
    assert torch.equal(got[:, rest], want[:, rest])
    for ref in (one, want):
        np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-6, atol=1e-7)


def test_compact_frame_in_three_rounds_matches_jax(monkeypatch):
    """A step budget of a third of the frame's steps: the compact frame
    runs its replay in at least three rounds, renders the default frame's
    bytes, and the JAX package's frame within the pipeline tests' gate
    (RMSE < 1e-3, bytes within 1 level; tests/test_torch_replay_plan.py)."""
    settings = dict(width=48, height=32, max_steps=160)
    pose = ((0.0, 3.0, -30.0), 0.0, -6.0)
    rgba = np.load(pathlib.Path(__file__).resolve().parent / "torch_data"
                   / "starfield_64x128.npy")
    sky = skybox_from_array(rgba, "cpu")
    cam = tcam.camera_state_from_pose(*pose)
    plans = []
    real_plan = pc.replay_plan

    def plan(total, capacity, order=None, rounds=pc.ROUNDS, lib=None):
        out = real_plan(total, capacity, order, rounds, lib)
        plans.append((out.counts.tolist(), out.rounds.tolist()))
        return out

    monkeypatch.setattr(pc, "replay_plan", plan)

    def render():
        return Renderer(TScene(max_steps=160), TSettings(**settings), skybox=sky,
                        device="cpu").render_np(cam, TEffects(), 0.5)

    default = render()
    (m, _, n_steps, _), table = plans[0]
    assert len(table) == 1 and table[0] == [0, m, 0, n_steps]
    monkeypatch.setattr(pc, "STEP_BUDGET", n_steps // 3)
    forced = render()
    (m1, m1_r, _, _), table1 = plans[1]
    assert sum(1 for r in table1 if r[1]) >= 3 and m1_r == m1 == m
    assert all(r[3] <= n_steps // 3 for r in table1)
    np.testing.assert_array_equal(forced, default)
    want = JRenderer(JScene(max_steps=160), JSettings(loop="while", **settings),
                     skybox_rgba=rgba).render_np(jcam.camera_state_from_pose(*pose),
                                                 JEffects(), 0.5)
    d = forced[..., :3].astype(np.int64) - want[..., :3].astype(np.int64)
    assert np.sqrt(np.mean((d / 255.0) ** 2)) < 1e-3
    assert np.abs(d).max() <= 1
