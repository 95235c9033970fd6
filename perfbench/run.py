"""Run one cell of the benchmark of heligym_tpu_torch once, on the card.

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The last line of standard output is one JSON
object: `correct`, `attempted`, `failed`, `metrics` (the cell's end-to-end
metrics, or with `--trace 1` its per-layer metrics), `device`, with
`--trace 1` `breakdown`, and last `checks`, each number that decided
`correct` beside its limit. Those numbers are also the last lines of
standard error. Without a CUDA card, or with fewer cards than the cell asks
for, it prints no result and exits with 2; it never falls back to the CPU.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def _fail(msg: str, code: int = 2):
    print(f"perfbench: {msg}", file=sys.stderr, flush=True)
    sys.exit(code)


def _caches():
    """Every cache of the program and of the libraries it loads at a fixed
    path inside the checkout, so that only a checkout's first run builds."""
    cache = os.path.join(ROOT, "build", "perfbench")
    os.environ["HELIGYM_TPU_TORCH_CACHE"] = os.path.join(cache, "trim")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["CUDA_CACHE_PATH"] = os.path.join(cache, "cuda")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _caches()
    sys.path[:0] = [HERE, ROOT]

    import torch
    from harness import runner, spec

    try:
        cell = spec.cell(args.workload)
    except (OSError, KeyError, ValueError) as e:
        _fail(f"cannot read the cell {args.workload!r}: {e}")
    if not torch.cuda.is_available():
        _fail("torch.cuda.is_available() is false: the benchmark runs on a CUDA card only")
    if torch.cuda.device_count() < cell.chips:
        _fail(f"the cell asks for {cell.chips} cards, {torch.cuda.device_count()} visible")
    try:
        import heligym_tpu_torch  # noqa: F401
    except ImportError as e:
        _fail(f"the port heligym_tpu_torch is not beside the benchmark: {e}")

    result = runner.run(cell, args.seed, args.seconds, bool(args.trace), "cuda", T_START)
    found = runner.forbidden_modules()
    if found:
        _fail(f"modules of the JAX stack or package are loaded: {found}", code=3)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
