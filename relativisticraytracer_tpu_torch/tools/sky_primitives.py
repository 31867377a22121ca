"""The cost of a per-lane gather from a block-resident table (port of
tools/bench_sky_primitives.py::bench_take_along_axis_kernel).

    python -m relativisticraytracer_tpu_torch.tools.sky_primitives

For each S in (8, 16, 32, 64): a table [t * S, 128] float32 and indices
[t * 8, 128] int32 in [0, S) with t = 2040, made on the device from a
seed. `take_along_kernel` (csrc/probes.cu) loads each tile's (S, 128)
table into shared memory and writes out[8i + r, c] = tab[S i + idx[8i + r,
c], c]; its plain twin is `torch.gather` on the (t, S, 128) view, which is
also the one PyTorch call that computes the function (the library time).
Each size reports the kernel's device time per call with the L2 cold (a
256 MiB buffer is cleared before every call, so the inputs come from HBM
as the byte bound assumes: at S <= 32 they would otherwise stay in the
H100's 50 MB L2 between calls), its byte bound (the table, the indices
and the output once each at 3.35 TB/s), torch.gather's time timed the
same way, and whether the two agree bitwise. The report goes to
chiprun_out/sky_primitives.json. The TPU tool's other two probes
(`bench_slice_widths`, `bench_onehot_shapes`) asked XLA questions about the
TPU's lane layout and matrix unit; they have no kernel to port.
"""

from __future__ import annotations

import argparse
import json
import pathlib
from typing import Optional

import torch

from relativisticraytracer_tpu_torch.ops import cuda_lib

T = 2040
SIZES = (8, 16, 32, 64)
PEAK_BYTES = 3.35e12  # H100 SXM HBM3 (NVIDIA's data sheet)
SCRUB_BYTES = 256 << 20  # cleared before each timed call: five times the H100's L2
OUT = pathlib.Path(__file__).resolve().parents[2] / "chiprun_out"


def inputs(s: int, t: int = T, device="cuda", seed: int = 0):
    """(tab [t * s, 128] float32 uniform in [0, 1), idx [t * 8, 128] int32
    in [0, s)), drawn on `device` from `seed`."""
    gen = torch.Generator(device=device).manual_seed(seed)
    tab = torch.rand((t * s, 128), generator=gen, device=device)
    idx = torch.randint(0, s, (t * 8, 128), generator=gen, device=device, dtype=torch.int32)
    return tab, idx


def take_along_plain(tab: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain twin of take_along_kernel: torch.gather along the table rows
    of each tile."""
    t = idx.shape[0] // 8
    s = tab.shape[0] // t
    return torch.gather(tab.view(t, s, 128), 1, idx.view(t, 8, 128).long()).view(t * 8, 128)


def take_along(tab: torch.Tensor, idx: torch.Tensor,
               lib: Optional[cuda_lib.KernelLibrary] = None) -> torch.Tensor:
    """take_along_kernel on CUDA tensors, its plain twin on CPU ones."""
    if tab.device.type == "cpu":
        return take_along_plain(tab, idx)
    out = torch.empty(idx.shape, dtype=torch.float32, device=idx.device)
    cuda_lib.resolve(lib).take_along(tab, idx, out, cuda_lib.current_stream(idx.device))
    return out


def byte_bound_ms(s: int, t: int = T) -> float:
    """Bytes the function must move (table + indices in, output out) over
    the HBM rate, in ms."""
    return (t * s * 128 * 4 + 2 * t * 8 * 128 * 4) / PEAK_BYTES * 1000.0


def cold_ms(fn, scrub: torch.Tensor, reps: int = 20) -> float:
    """Mean device ms of `reps` calls of `fn`, each after `scrub.zero_()`
    evicts the L2. Each call is bracketed by CUDA events queued behind the
    scrub, so the host's launch overlaps the scrub and is not counted."""
    fn()
    times = []
    for _ in range(reps):
        scrub.zero_()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        times.append((start, end))
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in times) / reps


def measure(device, lib=None, sizes=SIZES, t: int = T) -> dict:
    """{f"take_along_S{s}": {ms, bound_ms, gather_ms, bitwise}} for each
    size: `ms` and `gather_ms` are device ms per call with the L2 cold."""
    scrub = torch.empty(SCRUB_BYTES, dtype=torch.uint8, device=device)
    out = {}
    for s in sizes:
        tab, idx = inputs(s, t, device)
        idx_long = idx.view(t, 8, 128).long()
        got = take_along(tab, idx, lib)
        bitwise = bool(torch.equal(got, take_along_plain(tab, idx)))
        ms = cold_ms(lambda: take_along(tab, idx, lib), scrub)
        gather_ms = cold_ms(lambda: torch.gather(tab.view(t, s, 128), 1, idx_long), scrub)
        out[f"take_along_S{s}"] = dict(ms=ms, bound_ms=byte_bound_ms(s, t), gather_ms=gather_ms,
                                       bitwise=bitwise)
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(prog="relativisticraytracer_tpu_torch.tools.sky_primitives",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=str(OUT / "sky_primitives.json"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("sky_primitives: needs a CUDA device")
    dev = torch.device("cuda", torch.cuda.current_device())
    report = measure(dev, cuda_lib.kernels())
    for name, r in report.items():
        print(f"{name}: {r['ms']:.4f} ms a call (L2 cold), bound {r['bound_ms']:.4f}; "
              f"torch.gather {r['gather_ms']:.4f}; bitwise torch.gather {r['bitwise']}")
    report["device"] = torch.cuda.get_device_name(dev)
    out = pathlib.Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(report, indent=2))
    print(f"wrote {out}")
    return report


if __name__ == "__main__":
    main()
