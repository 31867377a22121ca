"""PyTorch port: properties of the record/replay split that hold inside
the port (ops/pallas_compact.py), on a pose where some rays cross the
media twice — the second time after lensing round the hole.

The split is exact by construction: the trajectory does not depend on the
media, a False skip probe contributes exactly zero, and a ray's replay
depends on its own records only. On the CPU the plain versions evaluate
exp/pow/sin/cos with SIMD code on whole vectors and scalar libm code on
the tail, so a result that batches rays differently (the plain march, a
merged slot) may differ in the last ulp: those comparisons carry rtol
1e-6 / atol 1e-7; the rest are bitwise."""

import numpy as np
import pytest
import torch

from relativisticraytracer_tpu_torch.config import CameraEffects as TEffects
from relativisticraytracer_tpu_torch.config import SceneConfig as TScene
from relativisticraytracer_tpu_torch.ops import pallas_compact as pc
from relativisticraytracer_tpu_torch.render import camera as tcam
from relativisticraytracer_tpu_torch.render import march as tmarch
from relativisticraytracer_tpu_torch.render.march import MarchState, march_step

torch.set_num_threads(2)

SKY = (64, 128)
HEAD = ((0.0, 15.0, -25.0), 0.0, -30.0)
HW, HH, HSTEPS = 32, 18, 1500


@pytest.fixture(scope="module")
def head_records():
    """The multi-crossing pose, records with slots 3 and 1."""
    cam = tcam.camera_state_from_pose(*HEAD)
    return {slots: pc.march_pallas_camera_sky_record(
        TScene(max_steps=HSTEPS), cam, TEffects(), 1.0, HW, HH, HSTEPS, *SKY,
        slots=slots, device="cpu")
        for slots in (3, 1)}


@pytest.fixture(scope="module")
def head_replay(head_records):
    """The sorted replay of the slots=3 records."""
    return pc.media_replay_sorted(TScene(max_steps=HSTEPS), head_records[3], 1.0)


def test_record_lengths_count_probing_steps(head_records):
    """Per-step exact recording: a ray's recorded length is its number of
    probing steps while it has at most `slots` segments; merged overflow
    spans (slots=1) add the gap steps, so they can only be longer."""
    cam = tcam.camera_state_from_pose(*HEAD)
    origin, d, _, _ = tcam.generate_rays(HW, HH, cam, TEffects(), "cpu")
    scene = TScene(max_steps=HSTEPS)
    count = torch.zeros(HW * HH)
    segs = torch.zeros(HW * HH)
    was = torch.zeros(HW * HH, dtype=torch.bool)

    def hook(rel, in_disk_zone, in_cloud_zone, active, intensity, trans, **_):
        nonlocal was, count, segs
        pd, pc_ = tmarch.media_probes(scene, rel, in_disk_zone, in_cloud_zone, active)
        probe = pd | pc_
        count = count + probe.float()
        segs = segs + (probe & ~was).float()
        was = probe
        return intensity, trans

    flat = origin.map(lambda a: a.reshape(-1).clone())
    z = torch.zeros_like(flat.x)
    st = MarchState(flat, d.map(lambda a: a.reshape(-1).clone()),
                    tmarch.Vec3(z, z, z), torch.ones_like(z),
                    torch.zeros_like(z, dtype=torch.bool),
                    torch.ones_like(z, dtype=torch.bool))
    for _ in range(HSTEPS):
        st = march_step(scene, st, torch.tensor(1.0), media_hook=hook)
    total3 = head_records[3].total.reshape(-1)
    total1 = head_records[1].total.reshape(-1)
    assert (segs > 1).any()  # the pose has multi-segment rays
    np.testing.assert_array_equal(total3.numpy(), count.numpy())
    assert (total1 >= count).all() and (total1[segs > 1] > count[segs > 1]).all()
    np.testing.assert_array_equal(head_records[3].hit.reshape(-1).numpy(),
                                  st.hit_horizon.float().numpy())


def test_sorted_replay_bitwise_equals_image_layout(head_records, head_replay):
    """Replay of a ray depends on its own records only: the longest-first
    list of the recorded rays replays bitwise the image-layout pass."""
    rec = head_records[3]
    ref = pc.media_replay(TScene(max_steps=HSTEPS), rec.rec, 1.0)
    order = pc.replay_order(rec.total)
    assert 0 < order.numel() < HW * HH
    lens = rec.total.reshape(-1)[order.long()]
    assert (lens[:-1] >= lens[1:]).all()
    for a, b in zip(list(head_replay[0]) + [head_replay[1]], list(ref[0]) + [ref[1]]):
        assert torch.equal(a, b)


def test_slot_overflow_merge_replays_the_same(head_records, head_replay):
    """slots=1 merges every later crossing into the first record; the
    replay then marches the probe-false gap steps, which add exact zeros.
    (The CUDA replay is bitwise here; the plain CPU version evaluates the
    merged rays in other batches, whose SIMD tails may move a last ulp.)"""
    a = head_replay
    b = pc.media_replay_sorted(TScene(max_steps=HSTEPS), head_records[1], 1.0)
    for x, y in zip(list(a[0]) + [a[1]], list(b[0]) + [b[1]]):
        np.testing.assert_allclose(x.numpy(), y.numpy(), rtol=1e-6, atol=1e-7)


def test_compact_replay_matches_plain_march(head_records, head_replay):
    """Record + replay is the plain march split in two: the same (I, T),
    up to the batch-dependent last ulp of the CPU transcendentals."""
    cam = tcam.camera_state_from_pose(*HEAD)
    o, d, _, _ = tcam.generate_rays(HW, HH, cam, TEffects(), "cpu")
    st = tmarch.march(TScene(max_steps=HSTEPS), o, d, torch.tensor(1.0), HSTEPS)
    rec = head_records[3]
    inten, trans = head_replay
    trans = torch.where(rec.hit > 0.5, 0.0, trans)
    assert torch.equal(rec.hit > 0.5, st.hit_horizon)
    for x, y in zip(list(inten) + [trans], list(st.intensity) + [st.transmittance]):
        np.testing.assert_allclose(x.numpy(), y.numpy(), rtol=1e-6, atol=1e-7)
