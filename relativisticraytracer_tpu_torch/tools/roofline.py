"""Measured issue ceilings of the card and the march's floor from them
(port of tools/vpu_roofline.py).

    python -m relativisticraytracer_tpu_torch.tools.roofline [--out PATH]

Two halves, both measured, as the TPU tool measured them:

  1. CEILING: `chain_kernel` (csrc/probes.cu) runs nothing but
     register-resident chains of one op — fma, mul, mul_bf16, rsqrt, exp
     — 16 independent chains x 32 ops an iteration in every thread, over
     enough blocks to fill every SM. Its rate in lane-ops/s comes from the
     CUDA-event difference between ITERS and 2 * ITERS, so the launch
     and the prologue cancel.
  2. DEMAND: the operations one ray-step of the function needs, counted by
     hand (VAC_OPS for a vacuum step, DISK_OPS and CLOUD_OPS for a step
     whose disk or cloud probe fires). The floor of a kernel is those
     operations over its steps, each issued alone (the library builds
     with -fmad=false) at the measured fp32 rate (`function_floor_ms`).
     It depends on the function, not on the binary: a kernel that issues
     needless instructions does not raise its own floor.

As a diagnostic beside the floor, the instructions one vacuum step of the
built library issues, by class (fp32, MUFU, integer/logic, branch,
memory), counted in its SASS (`cuobjdump -sass`) for the record kernel and
the three fused march kernels — the counterpart of the TPU tool's jaxpr
walk. Two counts: the march loop less its shading block (a static count,
which still holds blocks most steps skip), and the loop's shortest path,
the fewest instructions any iteration issues. Their time a lane-step
(`step_floor`) is the larger of, per pipe, the shortest iteration's
instructions over the pipe's measured rate (fp32 at the `mul` chain's
rate, MUFU at the `rsqrt` chain's rate times its MUFU instructions per
op) and all of them over the dispatch rate (one warp-instruction per
clock per sub-partition, measured as the faster of the `fma` and `mul`
chains). The report, with each floor per ray-step, goes to
chiprun_out/roofline.json; a caller multiplies by the step counts it
measured.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import re
import subprocess
from typing import Dict, Optional

import numpy as np
import torch

from relativisticraytracer_tpu_torch.ops import cuda_lib

TILE_ROWS = 8
CHAINS = 16             # independent accumulator chains (ILP)
INNER = 32              # ops per chain per loop iteration
OPS = cuda_lib.CHAIN_OPS
# float32(1.0 + 0.001 * c): each chain's starting factor (csrc/probes.cu kInit)
INIT = [float(np.float32(1.0 + 0.001 * c)) for c in range(CHAINS)]
ITERS = 500            # the chains' iterations; the rate is taken between ITERS and 2 * ITERS
# Float operations per ray-step, counted by hand from csrc/march_common.cuh:
# one per add, multiply, compare, select or math-library call (a powf or
# expf counts one, so these undercount and a floor from them stays a lower
# bound). The spec-rate bound of chip_smoke.py's kernel table and the
# measured floor (function_floor_ms) both use them.
VAC_OPS = 247      # zones, adaptive h, probes, RK4 (4 x geodesic_acc, 31 each), escape
DISK_OPS = 1475    # disk_block on a disk-probe step: 5-octave fbm (1,320) and the rest
CLOUD_OPS = 5220   # cloud_block on a cloud-probe step: 7 two-octave fbm + 5 ridge octaves
# The march kernels' SASS symbols, in the (has_spin 0, has_mass_pos 0)
# instance that SceneConfig() launches; and the record kernel's.
STEP_KERNELS = ("record_kernel", "march_camera_sky_kernel", "march_camera_kernel",
                "march_planes_kernel")
OUT = pathlib.Path(__file__).resolve().parents[2] / "chiprun_out"


def chain_plain(op: str, iters: int, x: torch.Tensor, tiles: int) -> torch.Tensor:
    """Plain twin of chain_kernel: the same chains as a torch loop over
    `tiles` copies of the [8, 128] tile `x` -> [tiles * 8, 128] float32.
    The CHAINS chains are independent and run the same ops, so they are
    one stacked tensor; fma multiplies and adds in float64 and rounds once
    to float32, as a fused multiply-add does (exact for the probe's input:
    the product and the sum fit float64's mantissa)."""
    x = x.repeat(tiles, 1)
    bf16 = op == "mul_bf16"

    def const(v):  # a scalar of x's dtype, rounded as the kernel rounds it
        return torch.full((), v, dtype=torch.float32, device=x.device).to(x.dtype)

    init = torch.tensor(INIT, dtype=torch.float32, device=x.device).to(x.dtype)
    a = x * init.view(CHAINS, 1, 1)
    b = x * 0.5 + 0.25
    k = const(1.0078125 if bf16 else float(np.float32(1.0000001)))
    k64, b64 = k.double(), b.double()
    for _ in range(iters * INNER):
        if op == "fma":
            a = (a.double() * k64 + b64).float()
        elif op in ("mul", "mul_bf16"):
            a = a * k
        elif op == "rsqrt":
            a = torch.rsqrt(a) + b
        else:
            a = torch.exp(a * float(np.float32(-1e-7)))
    acc = a[0]
    for c in range(1, CHAINS):
        acc = acc + a[c]
    return acc.to(torch.float32)


def chain(op: str, iters: int, x: torch.Tensor, tiles: int,
          lib: Optional[cuda_lib.KernelLibrary] = None) -> torch.Tensor:
    """The op chains over `tiles` tiles: chain_kernel on a CUDA tensor, its
    plain twin on a CPU one."""
    if op not in OPS:
        raise ValueError(f"op must be one of {OPS}, got {op!r}")
    if x.device.type == "cpu":
        return chain_plain(op, iters, x, tiles)
    out = torch.empty((tiles * TILE_ROWS, 128), dtype=torch.float32, device=x.device)
    cuda_lib.resolve(lib).chain(op, iters, x, out, cuda_lib.current_stream(x.device))
    return out


def chain_input(op: str, device) -> torch.Tensor:
    """The probe's input tile: 1.01 everywhere, bfloat16 for mul_bf16."""
    dtype = torch.bfloat16 if op == "mul_bf16" else torch.float32
    return torch.full((TILE_ROWS, 128), 1.01, dtype=dtype, device=device)


def ceiling_tiles(device) -> int:
    """The ceiling's tile count: 8 resident 256-thread blocks an SM for
    every SM, four times over."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return 4 * sms * 8 * 256 // (TILE_ROWS * 128)


def measure_ceiling(op: str, device, lib=None, reps: int = 3):
    """(lane-ops/s, seconds of the difference): CUDA-event times of ITERS
    and 2 * ITERS over ceiling_tiles (best of `reps` after a warm-up); the
    rate is the extra lane-ops over the extra time."""
    tiles, iters = ceiling_tiles(device), ITERS
    x = chain_input(op, device)

    def run(n):
        chain(op, n, x, tiles, lib)
        best = float("inf")
        for _ in range(reps):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            chain(op, n, x, tiles, lib)
            end.record()
            end.synchronize()
            best = min(best, start.elapsed_time(end) / 1000.0)
        return best

    t1, t2 = run(iters), run(2 * iters)
    lane_ops = tiles * TILE_ROWS * 128 * CHAINS * INNER * iters
    return lane_ops / max(t2 - t1, 1e-12), t2 - t1


# ---- SASS: the instructions a vacuum step issues

def sass_functions(text: str):
    """{function name: ([(address, instruction)], {label: address})} of
    `cuobjdump -sass` output."""
    funcs, cur = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            cur = funcs.setdefault(m.group(1), ([], {}))
            continue
        if cur is None:
            continue
        m = re.match(r"\s*(\.L_x_\d+):", line)
        if m:
            cur[1][m.group(1)] = len(cur[0])
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", line)
        if m:
            cur[0].append((int(m.group(1), 16), m.group(2)))
    return funcs


# The fp32 (FMA) pipe's instructions; packed half/bfloat16 pairs issue there too.
_FP32 = ("FADD", "FMUL", "FFMA", "FMNMX", "FSETP", "FSET", "FSEL", "FCHK", "FRND", "FSWZADD",
         "HADD2", "HMUL2", "HFMA2", "HMNMX2", "HSETP2")
_BRANCH = ("BRA", "BRX", "JMP", "JMX", "BSSY", "BSYNC", "EXIT", "RET", "CALL", "WARPSYNC",
           "BAR", "YIELD", "BREAK", "KILL", "NANOSLEEP", "BPT", "NOP")
_MEMORY = ("LD", "ST", "ATOM", "RED", "ULDC", "LDC", "LDS", "STS", "LDG", "STG", "CCTL")


def sass_class(opcode: str) -> str:
    """The class of a SASS opcode: fp32, mufu, branch, memory or int."""
    base = opcode.split(".")[0]
    if base == "MUFU":
        return "mufu"
    if base.removesuffix("32I") in _FP32:
        return "fp32"
    if base in _BRANCH:
        return "branch"
    if base.startswith(_MEMORY):
        return "memory"
    return "int"


def _opcode(ins: str) -> str:
    return ins.split()[1] if ins.startswith("@") else ins.split()[0]


def _count_classes(ops) -> Dict[str, int]:
    classes = dict.fromkeys(("fp32", "mufu", "int", "branch", "memory"), 0)
    for o in ops:
        classes[sass_class(o)] += 1
    return classes


def _shortest_iteration(instrs, lo, hi, target):
    """The opcodes of the fewest instructions one iteration of the loop
    [lo, hi] can issue: the shortest path in its control-flow graph from
    the head `lo` to a branch back to it (a conditional branch may go
    either way, a predicated instruction still issues, exits leave)."""
    import heapq

    dist, prev, heap = {lo: 1}, {}, [(1, lo)]
    while heap:
        d, k = heapq.heappop(heap)
        if d > dist[k]:
            continue
        ins = instrs[k][1]
        t = target(ins)
        if t == lo:
            path = [k]
            while path[-1] != lo:
                path.append(prev[path[-1]])
            return [_opcode(instrs[j][1]) for j in reversed(path)]
        conditional = ins.startswith("@")
        op = _opcode(ins)
        if op.startswith(("EXIT", "RET")):
            succ = [k + 1] if conditional else []
        elif t is not None:
            succ = [t] + ([k + 1] if conditional else [])
        else:
            succ = [k + 1]
        for n in succ:
            if lo <= n <= hi and d + 1 < dist.get(n, 1 << 30):
                dist[n], prev[n] = d + 1, k
                heapq.heappush(heap, (d + 1, n))
    return None


def _longest_loop(instrs, labels):
    """(lo, hi, branches, target) of a kernel's longest loop — the indices
    of its head and of its back-edge branch, every (branch, target) pair,
    and the branch-target function — or None."""
    index = {a: k for k, (a, _) in enumerate(instrs)}

    def target(ins):
        m = re.search(r"\bBRA(?:\.\w+)*\s+(?:`\((\.L_x_\d+)\)|0x([0-9a-f]+))", ins)
        if not m:
            return None
        return labels.get(m.group(1)) if m.group(1) else index.get(int(m.group(2), 16))

    branches = [(k, target(ins)) for k, (_, ins) in enumerate(instrs)]
    branches = [(k, t) for k, t in branches if t is not None]
    loops = [(t, k) for k, t in branches if t <= k]
    if not loops:
        return None
    lo, hi = max(loops, key=lambda l: l[1] - l[0])
    return lo, hi, branches, target


def sass_loop_stats(instrs, labels, flag_offsets=()):
    """The longest loop of a kernel's SASS (the march loop): its
    instructions; the largest forward branch inside it (the shading block
    a vacuum step skips); the instructions a vacuum step issues (loop less
    that block), of which fp32 (F*, MUFU), branches, reads of the scene's
    flag constants (c[0x0][offset] for `flag_offsets`), and the count of
    each class (sass_class); and the fewest instructions an iteration can
    issue (`shortest`, the loop's shortest path) with their classes."""
    loop = _longest_loop(instrs, labels)
    if loop is None:
        return None
    lo, hi, branches, target = loop
    skips = [(k, t) for k, t in branches if lo <= k < t <= hi]
    s0, s1 = max(skips, key=lambda b: b[1] - b[0], default=(hi, hi))
    vac = [instrs[k][1] for k in range(lo, hi + 1) if not s0 < k < s1]
    ops = [_opcode(ins) for ins in vac]
    flags = [ins for ins in vac if any(f"c[0x0][{hex(o)}]" in ins for o in flag_offsets)]
    shortest = _shortest_iteration(instrs, lo, hi, target) or ops
    return dict(loop=hi - lo + 1, shading_block=s1 - s0 - 1, vacuum=len(vac),
                fp32=sum(o.startswith(("F", "MUFU")) for o in ops),
                branches=sum(o.startswith("BRA") for o in ops), flag_reads=len(flags),
                classes=_count_classes(ops), shortest=len(shortest),
                shortest_classes=_count_classes(shortest))


def library_sass(lib: cuda_lib.KernelLibrary) -> str:
    """`cuobjdump -sass` of the built kernel library."""
    cuobjdump = pathlib.Path(cuda_lib._nvcc()).with_name("cuobjdump")
    return subprocess.run([str(cuobjdump), "-sass", str(lib.path)], capture_output=True,
                          text=True, timeout=120, check=True).stdout


def step_stats(sass: str, flag_offsets=()) -> Dict[str, dict]:
    """sass_loop_stats of the record kernel and of the three fused march
    kernels in their (has_spin 0, has_mass_pos 0) instance, by symbol."""
    out = {}
    for fname, (instrs, labels) in sass_functions(sass).items():
        sym = next((k for k in STEP_KERNELS if k in fname), None)
        if sym is not None and (sym == "record_kernel" or "ILb0ELb0E" in fname):
            out[sym] = sass_loop_stats(instrs, labels, flag_offsets)
    return out


# Each chain's op instruction and the ops one of it does (a packed bfloat16
# pair does two); the loop may be unrolled, so they give its op count.
_CHAIN_OP_INSTRUCTIONS = {"fma": {"FFMA": 1}, "mul": {"FMUL": 1},
                          "mul_bf16": {"HMUL2": 2, "HFMA2": 2, "HMUL": 1, "HFMA": 1},
                          "rsqrt": {"MUFU.RSQ": 1}, "exp": {"MUFU.EX2": 1}}


def chain_instructions(sass: str) -> Dict[str, dict]:
    """Per op of each chain kernel's loop: its instructions (the shortest
    iteration), by class, over the ops the iteration does — counted from
    its op instructions, so an unrolled loop or a packed bfloat16 pair
    counts right — and the loop's unroll factor."""
    symbols = {f"chain_kernelILi{k}E": op for k, op in enumerate(OPS) if op != "mul_bf16"}
    symbols["chain_bf16_kernel"] = "mul_bf16"
    out = {}
    for fname, (instrs, labels) in sass_functions(sass).items():
        op = next((o for sym, o in symbols.items() if sym in fname), None)
        if op is None:
            continue
        lo, hi, _, target = _longest_loop(instrs, labels)
        iteration = _shortest_iteration(instrs, lo, hi, target)
        weights = _CHAIN_OP_INSTRUCTIONS[op]
        done = sum(next((w for key, w in weights.items()
                         if o == key or o.startswith(key + ".")), 0) for o in iteration)
        per = max(done, 1)
        out[op] = dict(per_op=len(iteration) / per, unroll=done / (CHAINS * INNER),
                       classes={k: v / per for k, v in _count_classes(iteration).items()})
    return out


def rates(ceilings: Dict[str, float], mufu_per_op: float) -> Dict[str, float]:
    """Lane-instructions/s of each pipe from the measured op rates."""
    dispatch = max(ceilings["fma"], ceilings["mul"])
    return {"dispatch": dispatch, "fp32": ceilings["mul"],
            "mufu": ceilings["rsqrt"] * mufu_per_op}


def step_floor(classes: Dict[str, int], pipe_rates: Dict[str, float]):
    """(seconds a lane-step, the pipe that sets it): the larger of fp32 and
    MUFU instructions over their pipes' rates and all instructions over the
    dispatch rate."""
    times = {"fp32": classes["fp32"] / pipe_rates["fp32"],
             "mufu": classes["mufu"] / pipe_rates["mufu"],
             "dispatch": sum(classes.values()) / pipe_rates["dispatch"]}
    pipe = max(times, key=times.get)
    return times[pipe], pipe


def kernel_floor_ms(classes, pipe_rates, ray_steps: float, shade_ops: float = 0.0):
    """(ms, pipe) of the SASS diagnostic: `ray_steps` lane-steps of this
    step's instructions (step_floor), plus `shade_ops` hand-counted fp32
    shading operations at the fp32 rate."""
    per_step, pipe = step_floor(classes, pipe_rates)
    return (ray_steps * per_step + shade_ops / pipe_rates["fp32"]) * 1000.0, pipe


def function_floor_ms(pipe_rates, ray_steps: float, disk_steps: float = 0.0,
                      cloud_steps: float = 0.0) -> float:
    """The floor, ms: the function's hand-counted operations over these
    steps (VAC_OPS a ray-step, DISK_OPS and CLOUD_OPS a disk- or
    cloud-probe step), each one instruction at the measured fp32 rate."""
    ops = ray_steps * VAC_OPS + disk_steps * DISK_OPS + cloud_steps * CLOUD_OPS
    return ops / pipe_rates["fp32"] * 1000.0


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(prog="relativisticraytracer_tpu_torch.tools.roofline",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=str(OUT / "roofline.json"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("roofline: needs a CUDA device")
    dev = torch.device("cuda", torch.cuda.current_device())
    lib = cuda_lib.kernels()
    report = {"device": torch.cuda.get_device_name(dev), "iters": ITERS}
    ceilings = {}
    for op in OPS:
        ceilings[op], dt = measure_ceiling(op, dev, lib)
        report[f"{op}_lane_ops_per_s"] = ceilings[op]
        report[f"{op}_bench_s"] = dt
        print(f"{op}: {ceilings[op] / 1e12:.3f} T lane-ops/s (difference {dt * 1e3:.3f} ms)")
    sass = library_sass(lib)
    report["chain_instructions"] = chains = chain_instructions(sass)
    for op, c in chains.items():
        print(f"{op} chain: {c['per_op']:.4g} instructions an op "
              f"{({k: round(v, 4) for k, v in c['classes'].items() if v})}, loop unrolled "
              f"x{c['unroll']:.3g}")
    pipe_rates = rates(ceilings, chains["rsqrt"]["classes"]["mufu"])
    report["pipe_rates"] = pipe_rates
    # the floor per step: function_floor_ms of one step of each kind, in ns
    report["floor_ns_per_step"] = floor_ns = {
        "ray": function_floor_ms(pipe_rates, 1) * 1e6,
        "disk": function_floor_ms(pipe_rates, 0, disk_steps=1) * 1e6,
        "cloud": function_floor_ms(pipe_rates, 0, cloud_steps=1) * 1e6}
    print(f"floor a lane-step (hand-counted ops at the fp32 rate): ray {floor_ns['ray']:.4g} ns, "
          f"disk probe +{floor_ns['disk']:.4g}, cloud probe +{floor_ns['cloud']:.4g}")
    report["kernels"] = {}
    for sym, st in step_stats(sass).items():
        ms, pipe = kernel_floor_ms(st["shortest_classes"], pipe_rates, 1)
        report["kernels"][sym] = dict(st, sass_ns_per_step=ms * 1e6, sass_by=pipe)
        print(f"{sym}: vacuum step {st['vacuum']} instructions {st['classes']}, shortest "
              f"iteration {st['shortest']} {st['shortest_classes']}: {ms * 1e6:.4g} ns a "
              f"lane-step ({pipe})")
    out = pathlib.Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(report, indent=2))
    print(f"wrote {out}")
    return report


if __name__ == "__main__":
    main()
