#!/usr/bin/env python
"""Replay pytest-xdist's `--dist loadfile` schedule over a run's test times.

    python tools/xdist_replay.py run.xml
    python tools/xdist_replay.py run.xml --set test_new=1,46 --set test_other=0.1,20
    python tools/xdist_replay.py run.xml --drop test_new

`run.xml` is the `--junitxml` of a whole run. The replay follows xdist's
LoadScope scheduler (3.x): files are work units, queued in collection (path)
order and then by their number of tests, most first (ties keep path order);
each worker gets one file, then a second while at most 2 of its tests are
pending, and after every finished test another once at most 2 are pending.
Each worker runs its tests one after another at the junit times. `--set
NAME=T1,T2,...` gives a file (added if new) these per-test times, in
seconds, to see where it would land; `--drop NAME` leaves a file out.
Prints each worker's files with the time each was handed out, its end,
and the makespan (what the run's wall would be at these times).
"""
from __future__ import annotations

import argparse
import collections
import heapq
import xml.etree.ElementTree as ET


def load(path):
    """{file stem: [test seconds, in run order]} from a junit XML."""
    files = {}
    for case in ET.parse(path).getroot().iter("testcase"):
        parts = case.get("classname").split(".")
        stem = parts[1] if parts[0] == "tests" and len(parts) > 1 else parts[0]
        files.setdefault(stem, []).append(float(case.get("time")))
    return files


def replay(files, workers=6):
    """(makespan, [end of each worker], [[(file, handed out at)] of each
    worker])."""
    queue = collections.deque(sorted(sorted(files), key=lambda f: -len(files[f])))
    pending = [collections.deque() for _ in range(workers)]
    handed = [[] for _ in range(workers)]

    def assign(w, at):
        f = queue.popleft()
        handed[w].append((f, at))
        pending[w].extend(files[f])

    def reschedule(w, at):
        if queue and len(pending[w]) <= 2:
            assign(w, at)

    for w in range(workers):
        if queue:
            assign(w, 0.0)
    for w in range(workers):
        reschedule(w, 0.0)
    end = [0.0] * workers
    running = [(pending[w].popleft(), w) for w in range(workers) if pending[w]]
    heapq.heapify(running)
    while running:
        t, w = heapq.heappop(running)
        end[w] = t
        reschedule(w, t)
        if pending[w]:
            heapq.heappush(running, (t + pending[w].popleft(), w))
    return max(end), end, handed


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("junit")
    ap.add_argument("--set", action="append", default=[], metavar="NAME=T1,T2,...")
    ap.add_argument("--drop", action="append", default=[], metavar="NAME")
    ap.add_argument("--workers", type=int, default=6)
    args = ap.parse_args(argv)
    files = load(args.junit)
    for spec in args.set:
        name, times = spec.split("=")
        files[name] = [float(v) for v in times.split(",")]
    for name in args.drop:
        del files[name]
    makespan, end, handed = replay(files, args.workers)
    for w in range(args.workers):
        print(f"gw{w}: ends {end[w]:7.1f} s: "
              + ", ".join(f"{f} @{at:.0f}" for f, at in handed[w]))
    print(f"makespan {makespan:.1f} s")


if __name__ == "__main__":
    main()
