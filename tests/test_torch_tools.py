"""PyTorch port: the two measurement tools and their probe kernels'
plain twins (relativisticraytracer_tpu_torch/tools/; csrc/probes.cu),
against the TPU tools' Pallas kernel bodies run with `interpret=True`.

The JAX tool files are loaded by path and not edited. `chain_kernel`'s
plain twin matches `tools/vpu_roofline.py::_chain_kernel` to rtol 1e-5
for the float32 ops (a 64-op chain; XLA may contract or reassociate) and
to bfloat16's resolution for mul_bf16: XLA's CPU backend keeps bfloat16
element-wise chains in float32 inside a fusion and rounds only where it
stores (`xla_allow_excess_precision`), where the twin and the kernel round
every op. The take-along twin (torch.gather) matches the kernel body of
`tools/bench_sky_primitives.py::bench_take_along_axis_kernel` bitwise. The
kernels themselves run only on the card (tests/test_torch_kernels_gpu.py,
chip_smoke.py phase 10)."""

import functools
import importlib.util
import pathlib
import re
from fractions import Fraction

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from relativisticraytracer_tpu_torch.ops import cuda_lib
from relativisticraytracer_tpu_torch.tools import roofline as rf
from relativisticraytracer_tpu_torch.tools import sky_primitives as sp

torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _load_tool(name):
    spec = importlib.util.spec_from_file_location(f"_tpu_tool_{name}", ROOT / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def vpu_roofline():
    return _load_tool("vpu_roofline")


@pytest.fixture(scope="module")
def take_along_body():
    """The JAX tool's take-along kernel body and block specs, captured from
    its own pallas_call (the tool then records the stand-in's error and
    goes on; nothing is timed)."""
    mod = _load_tool("bench_sky_primitives")
    captured = []

    def capture(kernel, **kw):
        captured.append((kernel, kw))
        raise RuntimeError("captured")

    real = pl.pallas_call
    pl.pallas_call = capture
    try:
        mod.bench_take_along_axis_kernel()
    finally:
        pl.pallas_call = real
    assert len(captured) == len(sp.SIZES)
    return captured[0]


@pytest.mark.parametrize("op", rf.OPS)
def test_chain_plain_matches_jax_interpret(vpu_roofline, op):
    dtype = jnp.bfloat16 if op == "mul_bf16" else jnp.float32
    f = pl.pallas_call(
        functools.partial(vpu_roofline._chain_kernel, op, 2), grid=(1,),
        in_specs=[pl.BlockSpec((8, 128), lambda i: (0, 0))],
        out_specs=pl.BlockSpec((8, 128), lambda i: (i, 0)),
        out_shape=jax.ShapeDtypeStruct((8, 128), jnp.float32), interpret=True)
    want = np.asarray(f(jnp.full((8, 128), 1.01, dtype)))
    got = rf.chain(op, 2, rf.chain_input(op, "cpu"), 1).numpy()
    assert vpu_roofline.CHAINS == rf.CHAINS and vpu_roofline.INNER == rf.INNER
    rtol = 2.0 ** -7 if op == "mul_bf16" else 1e-5
    np.testing.assert_allclose(got, want, rtol=rtol)


@pytest.mark.parametrize("op", ["fma", "mul_bf16"])
def test_chain_plain_tiles_repeat_the_tile(op):
    one = rf.chain(op, 1, rf.chain_input(op, "cpu"), 1)
    three = rf.chain(op, 1, rf.chain_input(op, "cpu"), 3)
    assert three.shape == (24, 128) and three.dtype == torch.float32
    assert torch.equal(three, one.repeat(3, 1))
    with pytest.raises(ValueError, match="op must be"):
        rf.chain("div", 1, rf.chain_input("fma", "cpu"), 1)


def _round_f32(q: Fraction) -> np.float32:
    """The float32 nearest the rational q, ties to even."""
    f = np.float32(float(q))  # within one ulp (rounded twice)
    cands = [np.nextafter(f, np.float32(-np.inf)), f, np.nextafter(f, np.float32(np.inf))]
    return min(cands, key=lambda c: (abs(Fraction(float(c)) - q), int(c.view(np.uint32)) & 1))


def test_chain_plain_fma_rounds_once():
    """The fma twin is a fused multiply-add: each of its steps is a*k + b
    computed exactly and rounded once to float32, as __fmaf_rn rounds."""
    iters = 2
    x = np.float32(1.01)
    b = x * np.float32(0.5) + np.float32(0.25)
    k = Fraction(float(np.float32(1.0000001)))
    total = None
    for c in range(rf.CHAINS):
        a = x * np.float32(rf.INIT[c])
        for _ in range(iters * rf.INNER):
            a = _round_f32(Fraction(float(a)) * k + Fraction(float(b)))
        total = a if total is None else np.float32(total + a)
    got = rf.chain("fma", iters, rf.chain_input("fma", "cpu"), 1).numpy()
    assert np.all(got.view(np.uint32) == np.float32(total).view(np.uint32))


@pytest.mark.parametrize("s", sp.SIZES)
def test_take_along_plain_matches_jax_kernel_body(take_along_body, s):
    kernel, kw = take_along_body
    t = 3
    tab, idx = sp.inputs(s, t, "cpu", seed=s)
    in_specs = [pl.BlockSpec((s, 128), lambda i: (i, 0)),
                pl.BlockSpec((8, 128), lambda i: (i, 0))]
    assert [tuple(b.block_shape) for b in kw["in_specs"]][1] == (8, 128)
    f = pl.pallas_call(kernel, grid=(t,), in_specs=in_specs, out_specs=kw["out_specs"],
                       out_shape=jax.ShapeDtypeStruct((t * 8, 128), jnp.float32),
                       interpret=True)
    want = np.asarray(f(tab.numpy(), idx.numpy()))
    np.testing.assert_array_equal(sp.take_along(tab, idx).numpy(), want)


def test_take_along_inputs_and_bound():
    tab, idx = sp.inputs(16, 5, "cpu", seed=3)
    assert tab.shape == (80, 128) and idx.shape == (40, 128) and idx.dtype == torch.int32
    assert int(idx.min()) >= 0 and int(idx.max()) < 16
    again = sp.inputs(16, 5, "cpu", seed=3)
    assert torch.equal(tab, again[0]) and torch.equal(idx, again[1])
    # the table, the indices and the output once each
    want = (2040 * 64 * 128 * 4 + 2 * 2040 * 8 * 128 * 4) / 3.35e12 * 1e3
    assert sp.byte_bound_ms(64) == pytest.approx(want)


def test_probe_wrappers_refuse_cpu_tensors_and_bad_shapes():
    lib = object.__new__(cuda_lib.KernelLibrary)  # no build: the checks come first
    lib.launches = dict.fromkeys(cuda_lib.KERNELS, 0)
    x = torch.ones(8, 128)
    with pytest.raises(ValueError, match="CUDA"):
        lib.chain("fma", 1, x, torch.empty(16, 128), 0)
    with pytest.raises(ValueError, match="tiles"):
        lib.chain("fma", 1, x, torch.empty(12, 128), 0)
    with pytest.raises(ValueError, match="1..64"):
        lib.take_along(torch.empty(3 * 65, 128), torch.zeros(24, 128, dtype=torch.int32),
                       torch.empty(24, 128), 0)
    with pytest.raises(ValueError, match="CUDA"):
        lib.take_along(torch.empty(3 * 8, 128), torch.zeros(24, 128, dtype=torch.int32),
                       torch.empty(24, 128), 0)
    assert lib.launches["chain"] == lib.launches["take_along"] == 0
    assert "probes.cu" in cuda_lib.SOURCES and set(cuda_lib.PROBES) <= set(cuda_lib.KERNELS)


def test_probes_source_has_no_double_literals():
    """A bare literal such as 0.5 is a double in C++; the build's PTX scan
    would refuse the fp64 it makes. Every literal in probes.cu is float."""
    src = (ROOT / "relativisticraytracer_tpu_torch" / "csrc" / "probes.cu").read_text()
    code = re.sub(r"//[^\n]*", "", src)
    bare = re.findall(r"(?<![\w.])(\d+\.\d*(?:e[-+]?\d+)?|0x[0-9a-f]\.[0-9a-f]+p[-+]?\d+)(?![\w.])",
                      code)
    assert bare == []
    inits = re.findall(r"0x1\.[0-9a-f]+p\+0f", code)[:16]  # kInit, first in the file
    assert [float.fromhex(h[:-1]) for h in inits] == rf.INIT


SASS = """
        Function : _Z12record_kernelv
        /*0000*/                   MOV R1, c[0x0][0x28] ;
.L_x_0:
        /*0010*/                   FADD R2, R2, R3 ;
        /*0020*/                   FFMA R2, R2, R3, R4 ;
        /*0030*/                   MUFU.RSQ R5, R2 ;
        /*0040*/              @P0  BRA `(.L_x_1) ;
        /*0050*/                   FMUL R6, R6, R6 ;
        /*0060*/                   FMUL R6, R6, R6 ;
        /*0070*/                   LDG.E R7, [R8.64] ;
.L_x_1:
        /*0080*/                   ISETP.GE.AND P1, PT, R9, c[0x0][0x230], PT ;
        /*0090*/                   IADD3 R9, R9, 0x1, RZ ;
        /*00a0*/              @!P1 BRA `(.L_x_0) ;
        /*00b0*/                   STG.E [R8.64], R2 ;
        /*00c0*/                   EXIT ;
"""


def test_sass_loop_stats_and_classes():
    funcs = rf.sass_functions(SASS)
    (instrs, labels), = funcs.values()
    st = rf.sass_loop_stats(instrs, labels, flag_offsets=(0x230,))
    # loop 0010..00a0 (10 instructions); the forward branch skips 0050..0070
    assert (st["loop"], st["shading_block"], st["vacuum"]) == (10, 3, 7)
    assert st["classes"] == {"fp32": 2, "mufu": 1, "int": 2, "branch": 2, "memory": 0}
    assert st["flag_reads"] == 1 and st["branches"] == 2
    for op, cls in (("FSETP.GT.AND", "fp32"), ("FMNMX", "fp32"), ("FADD32I", "fp32"),
                    ("MUFU.EX2", "mufu"), ("LOP3.LUT", "int"), ("BSSY", "branch"),
                    ("LDS.U", "memory"), ("ULDC.64", "memory"), ("F2I.TRUNC", "int")):
        assert rf.sass_class(op) == cls, op
    assert rf.step_stats(SASS, flag_offsets=(0x230,))["record_kernel"] == st
    assert st["shortest"] == 7 and st["shortest_classes"] == st["classes"]


# Two skippable blocks: the largest (0x50-0x70) is the shading block, the
# smaller (0x90) still counts in the static vacuum step but not in the
# shortest iteration; the exit at 0xa0 leaves the loop.
SASS_TWO_BLOCKS = """
        Function : _Z19march_planes_kernelILb0ELb0EEvv
.L_x_0:
        /*0010*/                   FADD R2, R2, R3 ;
        /*0020*/              @P0  BRA `(.L_x_1) ;
        /*0030*/                   FMUL R6, R6, R6 ;
        /*0040*/                   FMUL R6, R6, R6 ;
        /*0050*/                   FMUL R6, R6, R6 ;
        /*0060*/                   MUFU.EX2 R6, R6 ;
.L_x_1:
        /*0070*/              @P1  BRA `(.L_x_2) ;
        /*0080*/                   IADD3 R9, R9, 0x1, RZ ;
.L_x_2:
        /*0090*/              @P2  EXIT ;
        /*00a0*/              @!P3 BRA `(.L_x_0) ;
        /*00b0*/                   EXIT ;
"""


def test_shortest_iteration_skips_every_optional_block():
    st = rf.step_stats(SASS_TWO_BLOCKS)["march_planes_kernel"]
    assert (st["loop"], st["shading_block"], st["vacuum"]) == (10, 4, 6)
    assert st["classes"] == {"fp32": 1, "mufu": 0, "int": 1, "branch": 4, "memory": 0}
    assert st["shortest"] == 5
    assert st["shortest_classes"] == {"fp32": 1, "mufu": 0, "int": 0, "branch": 4, "memory": 0}


def test_floors_from_measured_rates():
    ceilings = {"fma": 30e12, "mul": 32e12, "mul_bf16": 31e12, "rsqrt": 2e12, "exp": 1e12}
    rates = rf.rates(ceilings, mufu_per_op=2.0)
    assert rates == {"dispatch": 32e12, "fp32": 32e12, "mufu": 4e12}
    classes = {"fp32": 200, "mufu": 6, "int": 60, "branch": 5, "memory": 1}
    per_step, pipe = rf.step_floor(classes, rates)
    assert pipe == "dispatch" and per_step == pytest.approx(272 / 32e12)
    assert rf.step_floor(dict(classes, mufu=80), rates)[1] == "mufu"
    ms, pipe = rf.kernel_floor_ms(classes, rates, 1e9, shade_ops=32e9)
    assert pipe == "dispatch" and ms == pytest.approx((1e9 * 272 / 32e12 + 1e-3) * 1e3)


def test_function_floor_counts_operations_not_instructions():
    rates = {"dispatch": 33e12, "fp32": 32e12, "mufu": 4e12}
    want = (1e9 * rf.VAC_OPS + 2e7 * rf.DISK_OPS + 5e6 * rf.CLOUD_OPS) / 32e12 * 1e3
    assert rf.function_floor_ms(rates, 1e9, 2e7, 5e6) == pytest.approx(want)
    assert rf.function_floor_ms(rates, 1e9) == pytest.approx(1e9 * rf.VAC_OPS / 32e9)
    # the per-step SASS diagnostic is the same rule with one lane-step
    classes = {"fp32": 200, "mufu": 6, "int": 60, "branch": 5, "memory": 1}
    assert rf.kernel_floor_ms(classes, rates, 1)[0] == pytest.approx(272 / 33e12 * 1e3)


def test_roofline_cli_takes_only_an_output_path(capsys):
    with pytest.raises(SystemExit):
        rf.main(["--iters", "500"])
    assert "unrecognized arguments" in capsys.readouterr().err


def test_tools_need_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(SystemExit, match="CUDA"):
        rf.main([])
    with pytest.raises(SystemExit, match="CUDA"):
        sp.main([])


def _loop_function(name, body):
    lines = "".join(f"        /*{0x10 * (i + 1):04x}*/                   {ins} ;\n"
                    for i, ins in enumerate(body + ["@!P1 BRA `(.L_x_0)"]))
    return f"        Function : {name}\n.L_x_0:\n{lines}"


def test_chain_instructions_count_ops_from_op_instructions():
    """Ops per loop iteration come from the op instructions (a packed
    bfloat16 pair is two), so an unrolled or packed loop counts right."""
    sass = (_loop_function("_Z12chain_kernelILi3EEviiPKfPf",
                           ["MUFU.RSQ R2, R2", "FADD R2, R2, R3", "MUFU.RSQ R4, R4",
                            "FADD R4, R4, R3", "IADD3 R9, R9, 0x1, RZ"])
            + _loop_function("_Z17chain_bf16_kerneliiPK13__nv_bfloat16Pf",
                             ["HMUL2.BF16_V2 R2, R2, R3", "HMUL2.BF16_V2 R4, R4, R3",
                              "IADD3 R9, R9, 0x1, RZ"]))
    got = rf.chain_instructions(sass)
    assert sorted(got) == ["mul_bf16", "rsqrt"]
    assert got["rsqrt"]["per_op"] == 3.0  # 6 instructions, 2 ops
    assert got["rsqrt"]["classes"]["mufu"] == 1.0 and got["rsqrt"]["classes"]["fp32"] == 1.0
    assert got["mul_bf16"]["per_op"] == 1.0  # 4 instructions, 2 pairs = 4 ops
    assert got["mul_bf16"]["classes"]["fp32"] == 0.5
    assert got["mul_bf16"]["unroll"] == 4 / (rf.CHAINS * rf.INNER)
