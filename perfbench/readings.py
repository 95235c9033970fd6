"""The readings that the limits of `correct` are set from, on the card at a
cell's own size, many seeds in one process (the benchmark's own runs never
run this):

    python3 perfbench/readings.py --workload <name> --seeds 1,2,3 [--control]
        [--fault <one of the entry's FAULTS>]

Without `--control` or `--fault`: the program's set-up units on each seed
against the reference (the lower readings). `--control`: the reference in
the configuration's next lower precision put in the program's place (the
entry's `CONTROL`: TF32 matmuls for a learner cell, the state kept in
bfloat16 for the env-only rollout); `--fault`: the reference with one of
the entry's `FAULTS` planted in the program's place (the upper readings).
One JSON line per seed; `--out` appends them to a file as well. It needs a
CUDA card.
"""
import argparse
import json
import os
import statistics
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--fault")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    os.environ.setdefault("HELIGYM_TPU_TORCH_CACHE", os.path.join(ROOT, "build", "perfbench", "trim"))
    sys.path[:0] = [HERE, ROOT]

    import torch
    from harness import program, spec
    from reference import check

    if not torch.cuda.is_available():
        sys.exit("perfbench readings: no CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cell = spec.cell(args.workload)
    for s in args.seeds.split(","):
        seed = program.seed_of(int(s))
        t0 = time.perf_counter()
        prog = program.Program(cell.config, cell.traffic, seed, "cuda", here=cell.here)
        config, traffic = {**cell.config, "ppo": prog.ppo}, prog.traffic
        units = int(traffic["compared_units"])
        if args.control or args.fault:
            entry = prog.entry
            prog.free()
            control = check.entry(entry).CONTROL if args.control else None
            got = check.follow(config, traffic, seed, units, "cuda", control=control,
                               root=ROOT, fault=args.fault)
        else:
            got = prog.record(units)
            entry = prog.entry
            prog.free()
        ref = check.follow(config, traffic, seed, units, "cuda", root=ROOT)
        line = {"workload": args.workload, "seed": int(s),
                "mode": "control" if args.control else (args.fault or "program"),
                "numbers": check.compare(entry, got, ref),
                "seconds": time.perf_counter() - t0}
        if entry == "train_step":
            grads = ref[0]["first_grads"]
            floor = check.GRAD_FLOOR * statistics.median(grads)
            line["leaves_left_out"] = [i for i, g in enumerate(grads) if g < floor]
        line["device"] = torch.cuda.get_device_name()
        print(json.dumps(line), flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(line) + "\n")


if __name__ == "__main__":
    main()
