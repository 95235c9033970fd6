"""Reading a `torch.profiler` trace of a slice of the window.

The profiler records the card's kernels, copies and fills (CUPTI) and the
host's ops and the harness's own spans (`record_function`; their ranges
on the card's timeline are not device work and are left out). From them:
device time by operation name (the arithmetic of the port's
`utils/profiling.py::kernel_times_ms`, copied: the sum of each name's device
durations), the union of the device's busy intervals (an interval in which
two operations overlap counts once), and the longest idle gaps on the
device, each named by the innermost host op or span open when it began.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Dict, List, Tuple


@dataclasses.dataclass
class Trace:
    window_s: float                       # host clock of the traced slice
    busy_s: float                         # union of the device's busy intervals
    ops: Dict[str, Tuple[float, int]]     # device op name -> (seconds, launches)
    gaps: List[Tuple[str, float]]         # longest idle gaps: (host activity, seconds)
    units: int                            # units of the traffic in the slice

    def device_s(self, match: str = "") -> float:
        """Summed device seconds of the ops whose name contains `match`."""
        return sum(s for name, (s, _) in self.ops.items() if match in name)

    def launches(self, match: str) -> int:
        return sum(n for name, (_, n) in self.ops.items() if match in name)

    def breakdown(self, top: int = 10) -> dict:
        ops = sorted(self.ops.items(), key=lambda kv: -kv[1][0])[:top]
        return {"device_ops": [[short(name), s] for name, (s, _) in ops],
                "idle_gaps": [[short(name), s] for name, s in self.gaps[:top]]}


def short(name: str, width: int = 100) -> str:
    """A kernel's name without its argument list, cut to `width`."""
    name = name.replace("(anonymous namespace)::", "")
    name = name[5:] if name.startswith("void ") else name
    return name.split("(", 1)[0][:width]


def _union(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[Tuple[int, int]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def _host_label(t: int, host: List[Tuple[int, int, str]]) -> str:
    """The innermost (latest-starting) host event open at time `t`."""
    best = None
    for a, b, name in host:
        if a <= t < b and (best is None or a > best[0]):
            best = (a, name)
    return best[1] if best else "host idle"


def read(prof, window_s: float, units: int, top: int = 10) -> Trace:
    from torch.autograd import DeviceType

    events = prof.profiler.kineto_results.events()
    spans = {e.name() for e in events if e.is_user_annotation()}
    device, host = [], []
    for e in events:
        a, d = e.start_ns(), e.duration_ns()
        if e.device_type() == DeviceType.CUDA:
            # the card's own work; a span's range on the card's timeline is not
            if not e.is_user_annotation() and e.name() not in spans:
                device.append((a, a + d, e.name()))
        elif d > 0:
            host.append((a, a + d, e.name()))
    ops: Dict[str, Tuple[float, int]] = {}
    for a, b, name in device:
        s, n = ops.get(name, (0.0, 0))
        ops[name] = (s + (b - a) * 1e-9, n + 1)
    busy = _union([(a, b) for a, b, _ in device])
    gaps = sorted(((busy[i + 1][0] - busy[i][1], busy[i][1]) for i in range(len(busy) - 1)),
                  reverse=True)[:top]
    return Trace(window_s=window_s, busy_s=sum(b - a for a, b in busy) * 1e-9, ops=ops,
                 gaps=[(_host_label(t, host), g * 1e-9) for g, t in gaps], units=units)


@contextlib.contextmanager
def profiled(sync):
    """Profile the block (host and card); yields a dict that holds, on exit,
    the profiler and the host-clock seconds of the block, which ends in
    `sync()`."""
    from torch.profiler import ProfilerActivity, profile

    out = {}
    sync()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        yield out
        sync()
        out["window_s"] = time.perf_counter() - t0
    out["prof"] = prof
