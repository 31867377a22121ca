"""PyTorch port: the JAX package's call forms bind in the port.

For every public function, public method and class of every module of the
JAX package that has a counterpart in the port, the call form JAX's callers
write (the required parameters by position, the optional ones by keyword)
binds to the port's `inspect.signature`, and each positional argument lands
on the port's parameter of the same name. The port may add parameters
(`device`, `lib`, keyword-only arguments). EXEMPT names, with a reason
each, the JAX parameters the port takes in another form or not at all;
any other divergence fails, and so does an exemption that matches no JAX
parameter any more.

Beside the signatures: `RenderSettings.resolved_loop()` against JAX's, the
`cuda` default of every entry point whose JAX form has no device, and
`skybox_from_array`'s JAX keyword against JAX's tables."""

import importlib
import importlib.util
import inspect
import pkgutil

import numpy as np
import pytest
import torch

import relativisticraytracer_tpu
from relativisticraytracer_tpu.config import RenderSettings as JSettings
from relativisticraytracer_tpu.render import skybox as jsky
from relativisticraytracer_tpu_torch.config import CameraEffects as TEffects
from relativisticraytracer_tpu_torch.config import RenderSettings as TSettings
from relativisticraytracer_tpu_torch.config import kernel_loop
from relativisticraytracer_tpu_torch.core import vecmath as tvec
from relativisticraytracer_tpu_torch.render import camera as tcam
from relativisticraytracer_tpu_torch.render import skybox as tsky

torch.set_num_threads(2)

JAX_ROOT = relativisticraytracer_tpu.__name__
PORT_ROOT = JAX_ROOT + "_torch"

# Pallas's interpret mode and the TPU launchers' block/unroll knobs: TPU
# mechanisms, not contracts (ROADMAP queue 1); the port's CPU path is the
# `device` argument, its launch geometry fixed in csrc/.
_INTERPRET = "Pallas's interpret mode: the port runs the plain versions on device='cpu'"
_KNOB = "a TPU launch knob (ROADMAP queue 1): the port's launch geometry is fixed in csrc/"

# "module:qualname" -> {JAX parameter: (what the port takes instead, reason)}.
# What the port takes: a tuple of its parameter names in that place (empty:
# nothing), or "keyword": the same name, by keyword only.
EXEMPT = {
    "render.march:march_step": {
        "media_cond": ((), "a lax.cond skip of media-free row groups on the TPU; the port's "
                           "skip is the per-ray probe"),
        "media_group_rows": ((), "the row-group size of that lax.cond skip"),
    },
    "ops.pallas_march:pack_camera_scalars": {
        "with_ca": ((), "the SMEM ABI of the TPU kernels (whether the CA scalars are packed); "
                        "the port always packs them"),
    },
    "ops.pallas_compact:media_replay_sorted": {
        "records": (("record",), "the port takes the record kernel's Record, not JAX's "
                                 "record planes"),
        "max_steps": ("keyword", "the port's fourth parameter is `lib`; the step cap is "
                                 "optional there"),
        "slots": ((), "read from the Record's planes in the port"),
        "unroll": ((), _KNOB),
        "b_rows": ((), _KNOB),
        "dense_b_rows": ((), _KNOB),
        "interpret": ((), _INTERPRET),
    },
    "ops.pallas_compact:render_frame_pallas_compact": {"interpret": ((), _INTERPRET)},
    "ops.pallas_march:render_frame_pallas": {"interpret": ((), _INTERPRET)},
    "ops.pallas_sky:sky_background_windowed": {
        "coords": (("idx", "fx", "fy"), "the port takes the coordinate planes one by one"),
        "sub_rows": ((), _KNOB + " (SUB_ROWS)"),
        "br": ((), _KNOB + " (WIN_BR)"),
        "bc": ((), _KNOB + " (WIN_BC)"),
        "fallback_rows": ((), _KNOB + " (FALLBACK_ROWS)"),
        "interpret": ((), _INTERPRET),
    },
}


def _module_pairs():
    names = [JAX_ROOT] + sorted(
        m.name for m in pkgutil.walk_packages(relativisticraytracer_tpu.__path__,
                                              JAX_ROOT + "."))
    pairs = []
    for name in names:
        port = PORT_ROOT + name[len(JAX_ROOT):]
        if importlib.util.find_spec(port) is not None:
            pairs.append((name[len(JAX_ROOT) + 1:] or "(root)", name, port))
    return pairs


MODULES = _module_pairs()


def _public(jmod, pmod):
    """(qualname, JAX callable, port callable or None) of every public
    function, class and class method that `jmod` defines."""
    for name, obj in vars(jmod).items():
        if name.startswith("_") or getattr(obj, "__module__", None) != jmod.__name__:
            continue
        if inspect.isfunction(obj):
            yield name, obj, getattr(pmod, name, None)
        elif inspect.isclass(obj):
            pcls = getattr(pmod, name, None)
            yield name, obj, pcls
            for mname, meth in vars(obj).items():
                if not mname.startswith("_") and inspect.isfunction(meth):
                    yield f"{name}.{mname}", meth, getattr(pcls, mname, None)


def _divergence(key, jfn, pfn, used):
    """None where JAX's call form binds to the port's signature, else why not."""
    if pfn is None:
        return "missing in the port"
    jsig, psig = inspect.signature(jfn), inspect.signature(pfn)
    exempt = EXEMPT.get(key, {})
    pos, kw = [], {}
    for p in jsig.parameters.values():
        if p.kind in (p.VAR_POSITIONAL, p.VAR_KEYWORD):
            continue
        names = (p.name,)
        by_keyword = p.default is not p.empty or p.kind is p.KEYWORD_ONLY
        if p.name in exempt:
            used.add((key, p.name))
            instead = exempt[p.name][0]
            if instead == "keyword":
                by_keyword = True
            else:
                names = instead
        for n in names:
            if by_keyword:
                kw[n] = object()
            else:
                pos.append(n)
    try:
        psig.bind(*pos, **kw)
    except TypeError as e:
        return f"{e}: JAX {jsig}, port {psig}"
    params = list(psig.parameters)
    for i, n in enumerate(pos):
        if i >= len(params) or params[i] != n:
            return (f"positional {i} is {n!r} in JAX, {params[i] if i < len(params) else None!r} "
                    f"in the port")
    return None


@pytest.mark.parametrize("short,jname,pname", MODULES, ids=[m[0] for m in MODULES])
def test_jax_call_forms_bind_in_the_port(short, jname, pname):
    jmod, pmod = importlib.import_module(jname), importlib.import_module(pname)
    used, bad = set(), []
    for qual, jfn, pfn in _public(jmod, pmod):
        if inspect.isclass(jfn) and pfn is not None and not callable(pfn):
            bad.append(f"{qual}: not callable in the port")
            continue
        why = _divergence(f"{short}:{qual}", jfn, pfn, used)
        if why:
            bad.append(f"{qual}: {why}")
    assert not bad, "\n".join(bad)
    stale = [(k, p) for k, ps in EXEMPT.items() if k.split(":")[0] == short for p in ps
             if (k, p) not in used]
    assert not stale, f"exemptions that match no JAX parameter: {stale}"


def test_every_exemption_names_a_ported_module_and_a_reason():
    shorts = {m[0] for m in MODULES}
    for key, params in EXEMPT.items():
        assert key.split(":")[0] in shorts, key
        for name, (instead, reason) in params.items():
            assert reason and (instead == "keyword" or isinstance(instead, tuple)), (key, name)


@pytest.mark.parametrize("loop", ["while", "scan", "pallas", "auto"])
def test_resolved_loop_reports_the_frame_program(loop):
    """"while", "scan" and "pallas" resolve as in JAX; "auto" is "pallas" on
    every device (the port's "auto" runs the kernel programs), where JAX
    resolves it to "while" off a TPU. kernel_loop reads the same value."""
    got = TSettings(loop=loop).resolved_loop()
    if loop == "auto":
        assert got == "pallas"
        assert JSettings(loop=loop).resolved_loop() == "while"  # JAX on the CPU
    else:
        assert got == JSettings(loop=loop).resolved_loop() == loop
    assert kernel_loop(TSettings(loop=loop)) == (got == "pallas")


def test_unknown_loop_resolves_as_in_jax_and_kernel_loop_refuses_it():
    assert TSettings(loop="bogus").resolved_loop() == JSettings(loop="bogus").resolved_loop()
    with pytest.raises(ValueError, match="unknown loop strategy"):
        kernel_loop(TSettings(loop="bogus"))


# the entry points whose JAX form has no device argument
NO_DEVICE_IN_JAX = [tsky.skybox_from_array, tcam.generate_rays, tcam.uv_planes, tvec.vec3]


@pytest.mark.parametrize("fn", NO_DEVICE_IN_JAX, ids=lambda f: f.__name__)
def test_device_defaults_to_cuda(fn):
    assert inspect.signature(fn).parameters["device"].default == "cuda"


@pytest.mark.parametrize("short,jname,pname", MODULES, ids=[m[0] for m in MODULES])
def test_every_counterpart_with_a_device_defaults_to_cuda(short, jname, pname):
    """A port function that stands for a public JAX function and takes a
    device either requires it or defaults to `cuda`, never to the CPU."""
    jmod, pmod = importlib.import_module(jname), importlib.import_module(pname)
    bad = []
    for qual, _, pfn in _public(jmod, pmod):
        if pfn is None or not callable(pfn):
            continue
        try:
            params = inspect.signature(pfn).parameters
        except (TypeError, ValueError):
            continue
        p = params.get("device")
        if p is not None and p.default is not p.empty and p.default != "cuda":
            bad.append(f"{qual}: device={p.default!r}")
    assert not bad


def test_jax_forms_stay_on_the_card():
    """JAX's call forms run with the `cuda` default: on a card their
    tensors are CUDA tensors; without one they fail, never falling back
    to the CPU."""
    rgba = np.zeros((4, 8, 4), np.uint8)
    calls = {
        "skybox_from_array": lambda: tsky.skybox_from_array(rgba, fast_table=True).qr,
        "skybox_from_array, one argument": lambda: tsky.skybox_from_array(rgba).q4,
        "generate_rays": lambda: tcam.generate_rays(8, 4, tcam.default_camera(),
                                                    TEffects())[0].x,
        "vec3": lambda: tvec.vec3(1.0, 2.0, 3.0, dtype=torch.float32).x,
    }
    for name, call in calls.items():
        if torch.cuda.is_available():
            assert call().device.type == "cuda", name
        else:
            with pytest.raises((RuntimeError, AssertionError)):
                call()


@pytest.mark.parametrize("fast_table", [True, False])
def test_skybox_from_array_takes_jax_keyword(fast_table):
    """The port's tables equal JAX's bit for bit (uint32 viewed as int32);
    the port builds the q4 table whatever `fast_table` says, because the
    sky kernel reads it."""
    rng = np.random.default_rng(3)
    rgba = rng.integers(0, 256, (6, 10, 4), dtype=np.uint8)
    want = jsky.skybox_from_array(rgba, fast_table=True)
    got = tsky.skybox_from_array(rgba, device="cpu", fast_table=fast_table)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b).view(np.int32))
    assert got.q4 is not None


def test_vec3_takes_jax_dtype():
    v = tvec.vec3(1, 2, 3, dtype=torch.float64, device="cpu")
    assert all(c.dtype == torch.float64 and c.device.type == "cpu" for c in v)
    assert [float(c) for c in tvec.vec3(1, 2, 3, device="cpu")] == [1.0, 2.0, 3.0]
