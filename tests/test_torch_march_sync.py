"""PyTorch port: the plain march's host syncs (render/march.py).

On a CUDA device each medium's block runs densely over the working set
(`torch.where(probe, acc + terms, acc)`), so a step reads nothing back to
the host: loop="scan" makes no host sync before its state is returned,
and loop="while" one a chunk, when it drops finished rays. The CPU keeps
the gathered form, so every CPU frame stays what it was. Here the dense
form is forced on the CPU: its `torch.nonzero` calls are counted, and its
(I, T, hit) held against the gathered form's within the same-ray
tolerance of tests/test_compact.py:180 (rtol 2e-6, atol 5e-7; the CPU's
vector math rounds by batch position, so not bitwise here; on the card
they are bitwise, tests/test_torch_kernels_gpu.py). The rays and the sim
clock are built on the device without a host copy."""

import math

import numpy as np
import pytest
import torch

from relativisticraytracer_tpu.core import noise as jnoise
from relativisticraytracer_tpu_torch.config import CameraEffects, SceneConfig
from relativisticraytracer_tpu_torch.core import noise as tnoise
from relativisticraytracer_tpu_torch.ops.pallas_march import _time_tensor
from relativisticraytracer_tpu_torch.render import camera as tcam
from relativisticraytracer_tpu_torch.render import march as tmarch

torch.set_num_threads(2)

STEPS, CHUNK = 130, 32   # 5 chunks, the last one short
POSES = {"golden": ((0.0, 5.0, -38.0), 0.0, -6.0),
         "edge": ((0.0, 1.5, -30.0), 0.0, -2.0)}


def _rays(pose):
    cam = tcam.camera_state_from_pose(*POSES[pose])
    o, d, _, _ = tcam.generate_rays(24, 16, cam, CameraEffects(), "cpu")
    return o, d, _time_tensor(3.0, "cpu")


@pytest.fixture
def nonzero_calls(monkeypatch):
    calls = []
    real = torch.nonzero

    def counted(*args, **kwargs):
        calls.append(1)
        return real(*args, **kwargs)

    monkeypatch.setattr(torch, "nonzero", counted)
    return calls


@pytest.mark.parametrize("loop", ["scan", "while"])
def test_dense_march_host_syncs(nonzero_calls, loop):
    """The dense form calls no `nonzero` in a step: "scan" none at all,
    "while" one a chunk but the last, at most ceil(max_steps / chunk)."""
    o, d, t = _rays("edge")
    st = tmarch.march(SceneConfig(max_steps=STEPS), o, d, t, STEPS, loop=loop,
                      chunk=CHUNK, dense=True)
    assert st.active.shape == o.x.shape
    if loop == "scan":
        assert len(nonzero_calls) == 0
    else:
        assert 0 < len(nonzero_calls) <= math.ceil(STEPS / CHUNK)
        assert len(nonzero_calls) == math.ceil(STEPS / CHUNK) - 1


def test_gathered_march_is_the_cpu_default(nonzero_calls):
    """On the CPU the march keeps the gathered form (a `nonzero` per
    medium and step): the state equals an explicit dense=False march bit
    for bit."""
    o, d, t = _rays("edge")
    scene = SceneConfig(max_steps=STEPS)
    a = tmarch.march(scene, o, d, t, STEPS, chunk=CHUNK)
    n = len(nonzero_calls)
    assert n > math.ceil(STEPS / CHUNK)
    b = tmarch.march(scene, o, d, t, STEPS, chunk=CHUNK, dense=False)
    assert len(nonzero_calls) == 2 * n
    for x, y in zip(tmarch._fields(a), tmarch._fields(b)):
        assert torch.equal(x, y)


@pytest.mark.parametrize("pose", sorted(POSES))
@pytest.mark.parametrize("loop", ["scan", "while"])
@pytest.mark.parametrize("media", ["both", "disk", "clouds"])
def test_dense_march_equals_gathered(pose, loop, media):
    o, d, t = _rays(pose)
    scene = SceneConfig(max_steps=STEPS, enable_disk=media != "clouds",
                        enable_clouds=media != "disk")
    a = tmarch.march(scene, o, d, t, STEPS, loop=loop, chunk=CHUNK, dense=False)
    b = tmarch.march(scene, o, d, t, STEPS, loop=loop, chunk=CHUNK, dense=True)
    # no medium moves a ray: position, velocity and the masks are bitwise
    for x, y in zip(list(a.p) + list(a.v) + [a.hit_horizon, a.active],
                    list(b.p) + list(b.v) + [b.hit_horizon, b.active]):
        assert torch.equal(x, y)
    ia, ib = torch.stack(list(a.intensity)), torch.stack(list(b.intensity))
    assert (ia > 0).any()
    torch.testing.assert_close(ib, ia, rtol=2e-6, atol=5e-7)
    torch.testing.assert_close(b.transmittance, a.transmittance, rtol=2e-6, atol=5e-7)


def test_dense_accumulate_keeps_the_accumulator_off_the_probe():
    """Off the probe the dense form returns the accumulator itself (the
    sign of zero too); on it, exactly the gathered a[idx] + t."""
    acc = [torch.tensor([-0.0, 0.0, 1.5, 2.0, -3.0])]
    sel = torch.tensor([True, False, True, False, True])
    terms = torch.tensor([0.25, 9.0, float("nan"), float("inf"), 1e-8])

    def block(x):
        return [x * 1.0]

    dense, = tmarch._accumulate(acc, block, sel, terms, dense=True)
    gathered, = tmarch._accumulate(acc, block, sel, terms, dense=False)
    assert torch.equal(dense[~sel], acc[0][~sel])
    assert torch.equal(torch.signbit(dense), torch.signbit(gathered))
    np.testing.assert_array_equal(dense.numpy(), gathered.numpy())


@pytest.mark.parametrize("loop", ["scan", "while"])
def test_scatter_runs_once_a_chunk(monkeypatch, loop):
    """march writes the working set back once a chunk ("scan": once), the
    call that chip_smoke's StepCounter counts per-ray steps through."""
    calls = []
    real = tmarch._scatter
    monkeypatch.setattr(tmarch, "_scatter", lambda *a: calls.append(1) or real(*a))
    o, d, t = _rays("golden")
    tmarch.march(SceneConfig(max_steps=STEPS, enable_clouds=False), o, d, t, STEPS,
                 loop=loop, chunk=CHUNK, dense=True)
    assert len(calls) == (1 if loop == "scan" else math.ceil(STEPS / CHUNK))


def test_noise_corners_made_on_the_device_are_the_reference_order():
    """noise3D's corner offsets, built from bits on the device, are the
    reference's corner order (math_utils.h:98-110), and noise3D still
    equals the JAX package's."""
    want = [(0, 0, 0), (1, 0, 0), (0, 1, 0), (1, 1, 0),
            (0, 0, 1), (1, 0, 1), (0, 1, 1), (1, 1, 1)]
    like = torch.zeros(3, 2)
    for axis in range(3):
        got = tnoise._corner_offsets(like, axis)
        assert got.shape == (8, 1, 1) and got.dtype == torch.float32
        assert got.reshape(-1).tolist() == [float(c[axis]) for c in want]
    rng = np.random.default_rng(5)
    p = [rng.uniform(-40, 40, 257).astype(np.float32) for _ in range(3)]
    got = tnoise.noise3D(tnoise.Vec3(*(torch.from_numpy(c) for c in p)))
    ref = jnoise.noise3D(jnoise.Vec3(*p))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("time", [0.1, 3, np.float32(7.3), np.float64(1e-3),
                                  np.array(2.5), torch.tensor(4.2, dtype=torch.float64)],
                         ids=["float", "int", "f32", "f64", "array", "tensor"])
def test_time_tensor_rounds_like_as_tensor(time):
    want = torch.as_tensor(time, dtype=torch.float32).reshape(())
    got = _time_tensor(time, "cpu")
    assert got.shape == () and got.dtype == torch.float32
    assert torch.equal(got, want)
