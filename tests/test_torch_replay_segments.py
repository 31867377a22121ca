"""PyTorch port: the replay march pass's segment order
(ops/pallas_compact.with_segments, the plain twin of csrc/replay.cu's
segment kernels) and the march twin that runs through it, on CPU tensors.

The march pass takes one thread per recorded segment of a round, in the
round's segment order: its non-empty (listed ray, slot) segments, longest
first, ties in (ray, slot) order, each with its list start (its ray's
offset less the round's base plus its earlier slots' lengths). Held here
against a host-side reference written with Python loops:
- every non-empty segment of each round exactly once, none of another
  round, the lengths non-increasing with the (ray, slot) tie order, and
  the starts, at forced capacities of one to five or more rounds, for the
  longest-first list and the image order;
- a length past the key's field saturates and keeps the rounds apart;
- the march twin driven through the order writes each round's step list
  bitwise `_replay_march_plain`'s (the twin of the per-ray mapping it
  replaced), and the CPU replay through it is the one-list replay's.

On the card the segment kernels and the march kernel are held bitwise
against these twins (tests/test_torch_kernels_gpu.py, chip_smoke.py
phase 3)."""

import numpy as np
import pytest
import torch

from relativisticraytracer_tpu_torch.config import CameraEffects, SceneConfig
from relativisticraytracer_tpu_torch.ops import pallas_compact as pc
from relativisticraytracer_tpu_torch.render import camera as tcam

torch.set_num_threads(2)

POSE = ((0.0, 1.5, -30.0), 0.0, -2.0)
STEPS, T, SKY = 400, 2.0, (64, 128)
W, H = 64, 48


def _scene():
    return SceneConfig(max_steps=STEPS, step_size_m=2.0)


@pytest.fixture(scope="module")
def record():
    cam = tcam.camera_state_from_pose(*POSE)
    return pc.march_pallas_camera_sky_record(_scene(), cam, CameraEffects(), T, W, H, STEPS,
                                             *SKY, device="cpu")


def _reference(rec, plan):
    """Each round's segments as (start, pixel * slots + slot), by Python
    loops over the round table: the round's rays in list order, each ray's
    slots in order, the empty ones dropped, then sorted by length, longest
    first, ties in (ray, slot) order."""
    slots = rec.shape[0]
    lens = rec[:, 6].reshape(slots, -1).to(torch.int64).tolist()
    order, offsets = plan.order.tolist(), plan.offsets.tolist()
    rounds = []
    for first, rays, base, _ in plan.rounds.tolist():
        segs = []
        for j in range(first, first + rays):
            start = offsets[j] - base
            for sl in range(slots):
                n = lens[sl][order[j]]
                if n > 0:
                    segs.append((-n, j, sl, start, order[j] * slots + sl))
                start += n
        rounds.append([(s[3], s[4]) for s in sorted(segs)])
    return rounds


def _split(plan):
    """plan.segments cut into rounds by segment_counts, as (start, packed)."""
    out, at = [], 0
    for c in plan.segment_counts.tolist():
        out.append([tuple(e) for e in plan.segments[at:at + c].tolist()])
        at += c
    return out


def _plan(record, cap_name, sorted_order, max_steps=STEPS):
    order = None if sorted_order else torch.arange(W * H, dtype=torch.int32)
    n_steps = int(record.total.sum())
    cap = {"a tenth": n_steps // 10, "a fifth": n_steps // 5, "a third": n_steps // 3,
           "half": n_steps // 2, "all fit": n_steps}[cap_name]
    plan = pc.replay_plan(record.total, cap, order)
    return pc.with_segments(plan, record.rec, max_steps)


CAPACITIES = ["a tenth", "a fifth", "a third", "half", "all fit"]


@pytest.mark.parametrize("cap_name", CAPACITIES)
@pytest.mark.parametrize("sorted_order", [True, False])
def test_segment_order_matches_the_host_reference(record, cap_name, sorted_order):
    """Every non-empty segment of each round once, in the round's place,
    longest first with ties in (ray, slot) order, each at its ray's offset
    less the round's base plus its earlier slots' lengths; the entries past
    the rounds' segments unwritten (-1)."""
    plan = _plan(record, cap_name, sorted_order)
    want = _reference(record.rec, plan)
    assert _split(plan) == want
    total = sum(len(r) for r in want)
    assert plan.segments.shape == (W * H * pc.SLOTS, 2) and plan.segments.dtype == torch.int32
    assert (plan.segments[total:] == -1).all()
    if cap_name in ("a tenth", "a third"):
        assert sum(1 for r in want if r) >= 3


@pytest.mark.parametrize("cap_name", CAPACITIES)
@pytest.mark.parametrize("sorted_order", [True, False])
def test_segment_order_covers_each_round_longest_first(record, cap_name, sorted_order):
    """The order's own properties: each round's segments are exactly the
    non-empty slots of its rays (none of another round, none twice), their
    lengths non-increasing, ties in (ray, slot) order, and their steps the
    round's, each segment's steps inside the round's list without overlap."""
    plan = _plan(record, cap_name, sorted_order)
    slots = pc.SLOTS
    lens = record.rec[:, 6].reshape(slots, -1).to(torch.int64)
    rank = torch.empty(W * H, dtype=torch.int64)
    rank[plan.order.long()] = torch.arange(W * H)  # a pixel's place in the list
    for (first, rays, base, steps), segs in zip(plan.rounds.tolist(), _split(plan)):
        pix = plan.order[first:first + rays].long()
        want = {(int(p) * slots + sl) for p in pix for sl in range(slots) if lens[sl, p] > 0}
        packed = [e[1] for e in segs]
        assert len(packed) == len(set(packed)) and set(packed) == want
        n = [int(lens[p % slots, p // slots]) for p in packed]
        assert all(a >= b for a, b in zip(n, n[1:]))
        ties = [(n[i], int(rank[packed[i] // slots]), packed[i] % slots) for i in range(len(n))]
        assert all(a[1:] < b[1:] for a, b in zip(ties, ties[1:]) if a[0] == b[0])
        covered = torch.zeros(steps, dtype=torch.int64)
        for (start, _), k in zip(segs, n):
            covered[start:start + k] += 1
        assert sum(n) == steps and bool((covered == 1).all())


def test_segment_key_saturates_past_its_field(record):
    """A step cap below the frame's longest segment (a key field too
    narrow): the longer segments sort as the longest of their round and the
    rounds stay apart, so each round still holds its own segments and the
    march twin still writes every entry of its list."""
    plan = _plan(record, "a third", True, max_steps=3)
    assert pc.segment_len_bits(plan.capacity, 3) == 2
    want = _reference(record.rec, plan)
    got = _split(plan)
    assert [sorted(r) for r in got] == [sorted(r) for r in want]
    scene = _scene()
    for r, row in enumerate(plan.rounds.tolist()):
        if row[1]:
            pos, _ = pc._replay_march_segments_plain(scene, record.rec, plan, r)
            assert not bool(pos.isnan().any())


def test_segment_len_bits():
    """The key's length field: the list's capacity, the record's step cap
    and 2^24 - 1 bound a segment."""
    assert pc.segment_len_bits(pc.STEP_BUDGET, 2000) == 11
    assert pc.segment_len_bits(pc.STEP_BUDGET, None) == 24
    assert pc.segment_len_bits(5, 2000) == 3
    assert pc.segment_len_bits(1, None) == 1


@pytest.mark.parametrize("cap_name", ["a tenth", "a third", "all fit"])
@pytest.mark.parametrize("sorted_order", [True, False])
def test_march_through_the_order_is_bitwise_the_per_ray_twin(record, cap_name, sorted_order):
    """Each round's step list from the march twin in the segment order is
    bitwise `_replay_march_plain`'s over the round's rays at their offsets
    less the base (the same entries, no entry left unwritten)."""
    scene = _scene()
    plan = _plan(record, cap_name, sorted_order)
    used = 0
    for r, (first, rays, base, steps) in enumerate(plan.rounds.tolist()):
        if not rays:
            continue
        used += 1
        sel = plan.order[first:first + rays].long()
        want = pc._replay_march_plain(scene, record.rec, sel,
                                      plan.offsets[first:first + rays] - base, steps)
        got = pc._replay_march_segments_plain(scene, record.rec, plan, r)
        assert not bool(got[0].isnan().any())
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert used >= (3 if cap_name != "all fit" else 1)


def test_replay_needs_the_segment_order(record):
    """A plan without its segment order does not replay: no fallback to
    another mapping."""
    plan = pc.replay_plan(record.total, int(record.total.sum()))
    with pytest.raises(ValueError, match="segment order"):
        pc._replay(_scene(), record.rec, T, plan, None)


def test_cpu_replay_through_the_order_matches_the_plain_replay(record):
    """The CPU replay (the passes' twins, the march through the segment
    order) at a tenth of the steps takes every ray in its rounds and gives
    the plain replay's (I, T), up to the CPU's batch-dependent last ulp
    (tests/test_torch_replay_rounds.py); the pixels with no replay keep
    I = 0, T = 1."""
    scene = _scene()
    n_steps = int(record.total.sum())
    inten, trans = pc.media_replay_sorted(scene, record, T, capacity=n_steps // 10,
                                          max_steps=STEPS)
    got = torch.cat([torch.stack(list(inten)).reshape(3, -1), trans.reshape(1, -1)])
    sel = pc.replay_order(record.total).long()
    ip, tp = pc._replay_plain(scene, record.rec, T, sel)
    want = torch.cat([torch.zeros(3, W * H).index_copy_(1, sel, ip),
                      torch.ones(1, W * H).index_copy_(1, sel, tp[None])])
    rest = torch.ones(W * H, dtype=torch.bool).index_fill_(0, sel, False)
    assert torch.equal(got[:, rest], want[:, rest])
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6, atol=1e-7)


def test_per_ray_order_writes_the_same_list(record):
    """tools/replay_traffic's per-ray order (the mapping the segment order
    replaced: round r's thread t takes slot t / m of its ray t % m, empty
    slots included), which the lane efficiency and the store probe read,
    drives the march twin to the same step lists; its lane efficiency is
    below the segment order's."""
    from relativisticraytracer_tpu_torch.tools.replay_traffic import march_lanes, per_ray_order

    scene = _scene()
    plan = _plan(record, "a third", True)
    old = per_ray_order(record.rec, plan)
    rows = plan.rounds.tolist()
    assert old.segment_counts.tolist() == [r[1] * pc.SLOTS for r in rows]
    for r, row in enumerate(rows):
        if row[1]:
            got = pc._replay_march_segments_plain(scene, record.rec, old, r)
            want = pc._replay_march_segments_plain(scene, record.rec, plan, r)
            assert all(torch.equal(a, b) for a, b in zip(got, want))
    lanes = march_lanes(record.rec, plan)
    assert lanes["lane_efficiency_per_ray"] < lanes["lane_efficiency"] <= 1.0
