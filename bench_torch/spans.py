"""The program's spans (`emosaic_tpu_torch.monitor.span`): their seconds a
render from the renders' records, and the device's idle time put down to
the innermost span open over it.

    python3 bench_torch/spans.py --workload <cell> --seed <n> --seconds <s>

runs one cell as `run.py --trace 1` does, prints its result line, and
then, on standard error, `idle by program span: ...`: the traced
window's idle time (`Trace.idle_gaps`' intervals) summed by the innermost
program span open over each part, and the share of the window in which
the device is idle and no span below the root `render` is open.
"""

from __future__ import annotations

import sys
from pathlib import Path

#: the prefix of a span's range on the profiler's clock
PREFIX = "emosaic:"
#: the span each render opens around the others
ROOT = "render"
#: the label of idle time with no span open
NONE = "no span"
#: entries of the breakdown
TOP = 10


def per_render(run, name: str, key: str = "s") -> float | None:
    """Mean `key` ("s" or "self_s") a render of the span `name` over the
    window's renders that hold a span record, or None when none holds
    `name`."""
    spans = [r.info["spans"] for r in run.records if r.info and "spans" in r.info]
    if not any(name in sp for sp in spans):
        return None
    return sum(sp[name][key] for sp in spans if name in sp) / len(spans)


def host_spans(prof) -> list:
    """The program's spans in a `torch.profiler` run as (name, start, end),
    in microseconds of the trace's clock, the name without `PREFIX`."""
    from torch.autograd import DeviceType

    out = []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if name.startswith(PREFIX) and e.device_type() != DeviceType.CUDA:
            s0 = e.start_ns() / 1e3
            out.append((name[len(PREFIX):], s0, s0 + e.duration_ns() / 1e3))
    return out


def _pieces(host: list, start: float) -> list:
    """The host's time from `start` on as (from, to, innermost open span or
    None) pieces, in order; the spans nest (one thread opens them)."""
    out, stack, t = [], [], start

    def upto(x):
        nonlocal t
        if x > t:
            out.append((t, x, stack[-1][0] if stack else None))
            t = x

    for name, s0, s1 in sorted(host, key=lambda e: (e[1], -e[2])):
        while stack and stack[-1][2] <= s0:
            upto(stack[-1][2])
            stack.pop()
        upto(s0)
        stack.append((name, s0, s1))
    while stack:
        upto(stack[-1][2])
        stack.pop()
    out.append((t, float("inf"), None))
    return out


def _idle_split(trace, host: list) -> dict:
    """{label: seconds} of the window's idle time by the innermost program
    span open over it."""
    busy = trace.union()
    edges = [trace.start] + [x for iv in busy for x in iv] + [trace.end]
    pieces = _pieces(host, trace.start)
    by, i = {}, 0
    for g0, g1 in zip(edges[::2], edges[1::2]):
        if g1 <= g0:
            continue
        while pieces[i][1] <= g0:
            i += 1
        j = i
        while j < len(pieces) and pieces[j][0] < g1:
            a, b = max(g0, pieces[j][0]), min(g1, pieces[j][1])
            label = pieces[j][2] or NONE
            by[label] = by.get(label, 0.0) + (b - a) / 1e6
            j += 1
    return by


def idle_by_span(trace, host: list) -> list:
    """[[label, seconds], ...]: the window's idle intervals (those of
    `Trace.idle_gaps`) split by the innermost program span open over each
    part (`NONE` where none is, the root's name where only the root is),
    summed by label, largest first, the first `TOP`."""
    by = _idle_split(trace, host)
    return sorted(([k, v] for k, v in by.items()), key=lambda kv: -kv[1])[:TOP]


def unattributed_pct(trace, host: list) -> float | None:
    """% of the traced window in which the device is idle and no span below
    the root is open, or None without a device trace."""
    if trace.window_s <= 0 or not trace.device:
        return None
    by = _idle_split(trace, host)
    return 100.0 * (by.get(NONE, 0.0) + by.get(ROOT, 0.0)) / trace.window_s


def main(argv=None) -> int:
    root = Path(__file__).resolve().parent.parent
    sys.path.insert(0, str(root))
    from bench_torch import run, trace

    argv = list(sys.argv[1:] if argv is None else argv)
    traced, real = [], trace.reduce

    def reduce(prof, renders):
        tr = real(prof, renders)
        traced.append((tr, host_spans(prof)))
        return tr

    trace.reduce = reduce
    try:
        rc = run.main(argv + ["--trace", "1"])
    finally:
        trace.reduce = real
    for tr, host in traced:
        split = ", ".join(f"{k} {v:.4f} s" for k, v in idle_by_span(tr, host))
        pct = unattributed_pct(tr, host)
        print(f"idle by program span: {split}; idle with no span below {ROOT}: "
              f"{'not measured' if pct is None else f'{pct:.2f}%'} of {tr.window_s:.4f} s, "
              f"{tr.renders} renders", file=sys.stderr)
    return rc


if __name__ == "__main__":
    sys.exit(main())
