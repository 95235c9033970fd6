#!/usr/bin/env python3
"""The gather probe on one CUDA card: the port's counterpart of
tools/exp_gather.py.

For each probe size and axis it makes the probe's inputs (numpy, seed 0:
f32 x (S, L), i32 idx (S, L)), runs the hand-written CUDA kernel
(heligym_tpu_torch/ops/cuda/gather.py), checks it against
np.take_along_axis and, bit for bit, against its plain version (also
launched into an output filled with NaN, so that an element it never writes
shows), and times it on the device beside torch.gather on the same inputs
and the bound (12 bytes per element over the card's 3.35 TB/s), in two
ways:

  hot:  200 back-to-back launches on the same inputs, which then sit in the
        50 MB L2 (as the TPU probe kept x in VMEM); torch.profiler's device
        time (a loop timed with CUDA events is paced by the host at these
        sizes and is printed beside it);
  cold: 50 launches, each after writing a 128 MB buffer, so that the inputs
        come from device memory; the gather's own device time per launch.
        The share of the bound is taken against this time. The flush leaves
        L2 full of dirty lines, whose write-back the gather pays for as it
        evicts them; "clean" repeats it with a read of another 128 MB after
        the write, so that the gather moves only its own bytes.

Besides the probe sizes it runs both kernels at (1024, 1022), where
L % 4 != 0 sends gather_axis0's tile through cp.async instead of TMA and
gather_axis1 through its scalar path (one element per load instead of 4),
and gather_axis1 at (8, 32768), whose long rows are split over column tiles.
`--parent PATH` (repeatable) builds another gather.cu (an earlier one, or
a variant of this one) through `build.load(src=...)` and times its kernels
in the same run, each held bit for bit against this kernel. Prints one line
per trial and kernel:

    axis0 S=1024 L=1024 [tma]: correct=True ... hot 4.4 us  cold 7.5 us ...

Run from the repo root: python3 tools/torch_exp_gather.py [--parent PATH]
"""
import argparse
import os
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from heligym_tpu_torch.ops.cuda import build, gather  # noqa: E402
from heligym_tpu_torch.utils.profiling import (device_time_ms, event_time_ms,  # noqa: E402
                                               kernel_times_ms)

AXIS0_SIZES = [(8, 128), (64, 128), (64, 1024), (256, 1024), (1024, 1024)]
AXIS1_SIZES = [(8, 128), (8, 1024), (64, 1024), (1024, 1024)]
UNALIGNED_SIZES = [(1024, 1022)]   # L % 4 != 0: cp.async (axis 0), scalar (axis 1)
LONG_ROW_SIZES = [(8, 32768)]      # axis 1: rows over many column tiles
HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory
FLUSH_BYTES = 128 << 20            # written before each cold launch (L2: 50 MB)
HOT_LAUNCHES, COLD_LAUNCHES = 200, 50


def probe_inputs(S, L, axis):
    """The probe's inputs, as tools/exp_gather.py makes them."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((S, L)).astype(np.float32)
    idx = rng.integers(0, S if axis == 0 else L, size=(S, L)).astype(np.int32)
    return x, idx


def launch_us(fn, n, match="gather", tries=3):
    """Device microseconds per launch of the kernels of `fn` whose name holds
    `match`, from a profile of `n` calls of `fn` (profiled again, up to
    `tries` times, where a profile holds no such kernel)."""
    for _ in range(tries):
        rows = [r for name, r in kernel_times_ms(fn, n).items() if match in name]
        if rows:
            return sum(r["ms"] for r in rows) / sum(r["count"] for r in rows) * 1e3
    raise RuntimeError(f"{tries} profiles show no kernel named like {match!r}")


def hot_us(fn, n=HOT_LAUNCHES):
    """(device, launch-loop) microseconds per call of `fn` on a warm L2: the
    profiler's device time per launch of its gather kernel, and the event
    time of the loop."""
    return launch_us(fn, n), event_time_ms(fn, n, warmup=10) * 1e3


class Flush:
    """What runs before each cold launch: a write of FLUSH_BYTES (`dirty`:
    L2 is then full of the flush's dirty lines, which the gather must write
    back as it evicts them), and in `clean` mode a read of another
    FLUSH_BYTES after it (L2 then holds clean lines of neither input)."""

    def __init__(self, device):
        self.w = torch.empty(FLUSH_BYTES // 4, dtype=torch.float32, device=device)
        self.r = torch.ones(FLUSH_BYTES // 4, dtype=torch.float32, device=device)

    def __call__(self, clean):
        self.w.fill_(1.0)
        if clean:
            self.r.sum()


def cold_us(fn, flush, clean=False, n=COLD_LAUNCHES):
    """Device microseconds per launch of the gather kernel of `fn`, each
    launch after `flush(clean)`, so that L2 holds none of its inputs."""
    def flushed():
        flush(clean)
        fn()
    return launch_us(flushed, n)


def raw_launcher(fns, axis, x, idx, fill=None):
    """A launch of a bound C entry point into a fresh output, filled with
    `fill` first where given (with NaN, an element the launch leaves
    unwritten shows: a fresh buffer may hold an earlier launch's answer)."""
    def run():
        out = torch.empty_like(x) if fill is None else torch.full_like(x, fill)
        err = fns[axis](x.data_ptr(), idx.data_ptr(), out.data_ptr(), x.shape[0],
                        x.shape[1], torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"gather_axis{axis} launch failed: cudaError {err}")
        return out
    return run


def trial(axis, S, L, flush, variants=None, device="cuda"):
    """One probe trial; returns its numbers as a dict."""
    kernel = gather.gather_axis0 if axis == 0 else gather.gather_axis1
    x_np, idx_np = probe_inputs(S, L, axis)
    x, idx = torch.from_numpy(x_np).to(device), torch.from_numpy(idx_np).to(device)
    out = kernel(x, idx)
    want = np.take_along_axis(x_np, idx_np, axis=axis)
    plain = gather.gather_plain(x, idx, axis)
    idx64 = idx.to(torch.int64)
    run = lambda: kernel(x, idx, check=False)
    library = lambda: torch.gather(x, axis, idx64)
    us, loop_us = hot_us(run)
    bound_us = S * L * gather.BYTES_PER_ELEMENT / HBM_BYTES_PER_S * 1e6
    row = {"name": f"gather_axis{axis}", "S": S, "L": L,
           "correct": bool(np.array_equal(out.cpu().numpy(), want)),
           "equal_plain": bool(torch.equal(out, plain)),
           "covers": bool(torch.equal(raw_launcher(gather.kernel_fns(), axis, x, idx,
                                                   fill=float("nan"))(), plain)),
           "max_abs_err": float((out - plain).abs().max()),
           "us": us, "loop_us": loop_us, "cold_us": cold_us(run, flush),
           "cold_clean_us": cold_us(run, flush, clean=True),
           "plain_us": device_time_ms(lambda: gather.gather_plain(x, idx, axis),
                                      HOT_LAUNCHES) * 1e3,
           "library_us": hot_us(library)[0],
           "cold_library_us": cold_us(library, flush),
           "cold_clean_library_us": cold_us(library, flush, clean=True),
           "bound_us": bound_us}
    row["cold_bound_share"] = bound_us / row["cold_us"]
    row["cold_clean_bound_share"] = bound_us / row["cold_clean_us"]
    # the path csrc/gather.cu takes for this shape (aligned inputs)
    row["load"] = {(0, True): "tma", (0, False): "cp.async",
                   (1, True): "vec4", (1, False): "scalar"}[axis, L % 4 == 0]
    row["variants"] = {}
    for label, fns in (variants or {}).items():
        launch = raw_launcher(fns, axis, x, idx)
        filled = raw_launcher(fns, axis, x, idx, fill=float("nan"))()
        row["variants"][label] = {"equal": bool(torch.equal(filled, out)),
                                  "us": hot_us(launch)[0],
                                  "cold_us": cold_us(launch, flush),
                                  "cold_clean_us": cold_us(launch, flush, clean=True)}
    return row


def print_row(r):
    axis = r["name"][-1]
    print(f"axis{axis} S={r['S']} L={r['L']} [{r['load']}]: correct={r['correct']} "
          f"equal to plain={r['equal_plain']} covers={r['covers']}  hot {r['us']:.3f} us  cold "
          f"{r['cold_us']:.3f} us ({100 * r['cold_bound_share']:.1f}% of the bound "
          f"{r['bound_us']:.3f} us)  cold, clean L2 {r['cold_clean_us']:.3f} us "
          f"({100 * r['cold_clean_bound_share']:.1f}%)  torch.gather hot "
          f"{r['library_us']:.3f} / cold {r['cold_library_us']:.3f} / clean "
          f"{r['cold_clean_library_us']:.3f} us  take_along_dim {r['plain_us']:.2f} us  "
          f"(launch loop {r['loop_us']:.2f} us)")
    for label, v in r["variants"].items():
        print(f"axis{axis} S={r['S']} L={r['L']}   {label}: equal={v['equal']}  "
              f"hot {v['us']:.3f} us  cold {v['cold_us']:.3f} us  clean "
              f"{v['cold_clean_us']:.3f} us")


def run_probe(device="cuda", variants=None):
    """Every trial of the probe, printed as it goes; returns the rows.
    `variants`: {label: bound C entry points} timed beside each trial."""
    flush = Flush(device)
    rows = []
    for axis, sizes in ((0, AXIS0_SIZES), (1, AXIS1_SIZES), (0, UNALIGNED_SIZES),
                        (1, UNALIGNED_SIZES + LONG_ROW_SIZES)):
        for S, L in sizes:
            r = trial(axis, S, L, flush, variants, device)
            rows.append(r)
            print_row(r)
    return rows


def build_variants(parents=()):
    """{path: bound C entry points} of other gather.cu sources; prints the
    SASS instruction count of every kernel of each build and of this one."""
    variants = {}
    for path in (None, *parents):
        src = path and os.path.abspath(path)
        lib = build.load(gather.KERNEL, src=src)
        counts = build.sass_counts(build.library_path(gather.KERNEL, src=src))
        print(f"[sass] {path or 'this build'}: " + ", ".join(
            f"{k} {v['instructions']}" for k, v in sorted(counts.items())))
        if path:
            variants[path] = gather.bind(lib)
    return variants


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", action="append", default=[],
                    help="another gather.cu, timed beside this one (repeatable)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print("device:", torch.cuda.get_device_name(0), "|", smi.stdout.strip())
    rows = run_probe(variants=build_variants(args.parent))
    bad = [r for r in rows if not (r["correct"] and r["equal_plain"] and r["covers"]
                                   and all(v["equal"] for v in r["variants"].values()))]
    if bad:
        sys.exit("a gather kernel disagrees with np.take_along_axis, its plain "
                 "version or a variant")
