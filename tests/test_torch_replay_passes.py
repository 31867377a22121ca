"""PyTorch port: the replay's three passes (ops/pallas_compact.py, the
plain twins of csrc/replay.cu's march, shade and composite kernels) on CPU
tensors — step lengths, offsets, the step-list layout and the composite
order — against the one-pass plain replay and against the JAX package.

Scenes: step_size_m = 2.0 and a camera in the disk plane, so that within
400 steps some rays cross the media once, some two or three times (after
lensing round the hole) and some never.

Tolerances: the march pass has no transcendental and its step list is
compared bitwise with the records. The composed passes against
`_replay_plain`: rtol 1e-6 / atol 1e-7. Both run each ray's arithmetic in
the same order, but torch's CPU exp/pow/sin/cos use SIMD code on whole
vectors and scalar libm code on the tail, and the passes batch a step by
its place in the step list where `_replay_plain` batches it by ray, so the
last ulp of a step can move (2 ulp measured). Against the JAX package's
XLA march: rtol/atol 1e-3, as in tests/test_torch_compact.py (torch's and
XLA's rsqrt/exp/pow/sin/cos differ in the last ulp, the noise amplifies
it, XLA's CPU code contracts some a*b+c)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from relativisticraytracer_tpu.config import CameraEffects as JEffects
from relativisticraytracer_tpu.config import SceneConfig as JScene
from relativisticraytracer_tpu.render import camera as jcam
from relativisticraytracer_tpu.render import march as jmarch
from relativisticraytracer_tpu_torch.config import CameraEffects as TEffects
from relativisticraytracer_tpu_torch.config import SceneConfig as TScene
from relativisticraytracer_tpu_torch.ops import pallas_compact as pc
from relativisticraytracer_tpu_torch.physics.integrators import rk4_step
from relativisticraytracer_tpu_torch.render import camera as tcam
from relativisticraytracer_tpu_torch.render import march as tmarch

torch.set_num_threads(2)

POSE = ((0.0, 1.5, -30.0), 0.0, -2.0)
STEPS, T, SKY = 400, 2.0, (64, 128)
# name: (scene kwargs, slots, (w, h))
CASES = {
    "full": (dict(), 3, (192, 108)),
    "slot_overflow": (dict(), 1, (192, 108)),
    "disk_only": (dict(enable_clouds=False), 3, (64, 48)),
    "clouds_only": (dict(enable_disk=False), 3, (64, 48)),
}


def _scene(kw):
    return TScene(max_steps=STEPS, step_size_m=2.0, **kw)


@pytest.fixture(scope="module")
def records():
    cam = tcam.camera_state_from_pose(*POSE)
    return {name: pc.march_pallas_camera_sky_record(
        _scene(kw), cam, TEffects(), T, w, h, STEPS, *SKY, slots=slots, device="cpu")
        for name, (kw, slots, (w, h)) in CASES.items()}


def _probes(scene, pos):
    rel = tmarch.Vec3(pos[:, 0], pos[:, 1], pos[:, 2])
    r2 = rel.x * rel.x + rel.y * rel.y + rel.z * rel.z
    zd, zc = tmarch.media_zones(scene, rel, r2)
    return tmarch.media_probes(scene, rel, zd, zc, torch.ones_like(zd))


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("sorted_order", [True, False])
def test_three_passes_match_plain_replay(records, case, sorted_order):
    kw, slots, _ = CASES[case]
    scene, rec = _scene(kw), records[case]
    if sorted_order:
        order, n_steps = pc.replay_list(rec.total)
        sel = order.long()
        assert n_steps == int(pc.step_lengths(rec.rec, sel).sum())
    else:  # media_sort=False: every pixel, zero-length rays included
        sel = torch.arange(rec.total.numel())
    segs = (rec.rec[:, 6] > 0).sum(0).reshape(-1)[sel]
    want = pc._replay_plain(scene, rec.rec, T, sel)
    got = pc._replay_passes_plain(scene, rec.rec, T, sel)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-6, atol=1e-7)
    if case == "full":  # rays with 0 (image order only), 1, 2 and 3 segments
        assert {1, 2, 3} <= set(segs.tolist())
        assert (segs == 0).any() == (not sorted_order)
    if case == "slot_overflow":  # merged crossings: probe-False gap steps
        assert (rec.total > records["full"].total).any()


def test_step_list_layout(records):
    """Offsets are the exclusive prefix sums of the listed rays' lengths;
    each slot's steps follow its ray's earlier slots', the first holding
    the recorded pre-step position (rel = p without a mass offset); each
    step holds rel and the post-step v, bitwise the one-pass replay's
    trajectory; both probes can be True on a step."""
    scene, rec = _scene({}), records["full"]
    order, n_steps = pc.replay_list(rec.total)
    sel = order.long()
    lengths = pc.step_lengths(rec.rec, sel)
    offsets = pc.step_offsets(lengths)
    flat = rec.rec.reshape(rec.rec.shape[0], 7, -1)[:, :, sel]
    assert torch.equal(lengths, flat[:, 6].sum(0).long())
    assert offsets[0] == 0 and torch.equal(offsets[1:], torch.cumsum(lengths, 0)[:-1])
    pos, vel = pc._replay_march_plain(scene, rec.rec, sel, offsets, n_steps)
    first = offsets.clone()
    for s in range(flat.shape[0]):
        live = flat[s, 6] > 0
        assert torch.equal(pos[first[live], :3].T, flat[s, :3][:, live])
        first = first + flat[s, 6].long()
    # the last step of a ray's last slot is its segment's exit: one more
    # RK4 step from there is not in the list, and the next ray starts
    assert torch.equal(first, torch.cat([offsets[1:], offsets.new_tensor([n_steps])]))
    # post-step v of a slot's first step: one RK4 step from the record
    live = flat[0, 6] > 0
    p0 = tmarch.Vec3(*flat[0, :3][:, live])
    v0 = tmarch.Vec3(*flat[0, 3:6][:, live])
    rel = p0
    r2 = rel.x * rel.x + rel.y * rel.y + rel.z * rel.z
    zd, zc = tmarch.media_zones(scene, rel, r2)
    h = tmarch.adaptive_h(scene, r2, zd, zc, torch.ones_like(zd))
    _, v1 = rk4_step(scene, p0, v0, h)
    post = torch.cat([pos[offsets[live], 3:], vel[offsets[live]]], dim=1).T
    assert torch.equal(post, torch.stack(list(v1)))
    pd, pcl = _probes(scene, pos)
    assert (pd & pcl).any() and (pd | pcl).all()  # no gaps without merges


def test_composite_order_is_front_to_back(records):
    """Reversing each ray's steps changes (I, T) only through the order of
    compositing: T is a product (the same up to rounding), I is not."""
    scene, rec = _scene({}), records["full"]
    order, n_steps = pc.replay_list(rec.total)
    sel = order.long()
    offsets = pc.step_offsets(pc.step_lengths(rec.rec, sel))
    emit = pc._replay_shade_plain(scene, *pc._replay_march_plain(scene, rec.rec, sel, offsets,
                                                                 n_steps), T)
    inten, trans = pc._replay_composite_plain(emit, offsets)
    ends = torch.cat([offsets[1:], offsets.new_tensor([n_steps])])
    rev = torch.cat([torch.arange(int(e) - 1, int(b) - 1, -1) for b, e in zip(offsets, ends)])
    inten_r, trans_r = pc._replay_composite_plain(emit[rev], offsets)
    np.testing.assert_allclose(trans_r.numpy(), trans.numpy(), rtol=1e-5)
    assert (inten_r - inten).abs().max() > 1e-3


def test_shade_pass_adds_cloud_to_disk(records):
    """A step's emission is (0 + disk) + cloud: the full scene's shade pass
    is the disk-only and clouds-only passes' sum on the same steps, bitwise
    where one medium is off; a step's transmittance is exp(-opacity * h),
    1 where both probes are False."""
    rec = records["full"]
    order, n_steps = pc.replay_list(rec.total)
    sel = order.long()
    offsets = pc.step_offsets(pc.step_lengths(rec.rec, sel))
    steps = pc._replay_march_plain(_scene({}), rec.rec, sel, offsets, n_steps)
    full = pc._replay_shade_plain(_scene({}), *steps, T)
    disk = pc._replay_shade_plain(_scene(dict(enable_clouds=False)), *steps, T)
    cloud = pc._replay_shade_plain(_scene(dict(enable_disk=False)), *steps, T)
    pd, pcl = _probes(_scene({}), steps[0])
    assert torch.equal(full[pd & ~pcl], disk[pd & ~pcl])
    assert torch.equal(full[pcl & ~pd], cloud[pcl & ~pd])
    np.testing.assert_allclose(full[:, :3].numpy(), (disk + cloud)[:, :3].numpy(),
                               rtol=1e-6, atol=1e-7)
    # exp(-(a + b) h) = exp(-a h) exp(-b h), up to rounding
    np.testing.assert_allclose(full[:, 3].numpy(), (disk[:, 3] * cloud[:, 3]).numpy(),
                               rtol=1e-5)
    assert (full[~(pd | pcl), 3] == 1.0).all() and (full[pd | pcl, 3] < 1.0).any()


def test_three_passes_match_jax_march(records):
    """The port's record, replayed by the three passes, gives the JAX
    package's XLA march (I, T) on the same rays, with the capture mask."""
    rec = records["disk_only"]
    w, h = CASES["disk_only"][2]
    jscene = JScene(max_steps=STEPS, step_size_m=2.0, enable_clouds=False)
    jo, jd, _, _ = jcam.generate_rays(w, h, jcam.camera_state_from_pose(*POSE), JEffects())
    ref = jmarch.march(jscene, jo, jd, jnp.float32(T), STEPS, loop="while")
    order = pc.replay_order(rec.total)
    sel = order.long()
    inten_sel, trans_sel = pc._replay_passes_plain(_scene(dict(enable_clouds=False)),
                                                   rec.rec, T, sel)
    inten = torch.zeros((3, w * h))
    trans = torch.ones(w * h)
    inten[:, sel], trans[sel] = inten_sel, trans_sel
    hit = rec.hit.reshape(-1) > 0.5
    assert (hit.numpy() != np.asarray(ref.hit_horizon).reshape(-1)).mean() < 1e-3
    trans = torch.where(hit, 0.0, trans)
    assert float(inten.max()) > 0.0
    for got, want in zip(list(inten) + [trans], list(ref.intensity) + [ref.transmittance]):
        np.testing.assert_allclose(got.numpy(), np.asarray(want).reshape(-1),
                                   rtol=1e-3, atol=1e-3)

