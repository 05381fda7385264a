"""Runtime observability: RSS memory monitor + wall-time stats
(reference: src/main.rs:157-269), a throughput progress printer
(the reference's indicatif bars, main.rs:751-757, rendering.rs:60-66),
and the spans that time a render's stages into its record.
"""

from __future__ import annotations

import contextlib
import contextvars
import sys
import threading
import time

#: the record (a render's `RenderOutcome.info`) that spans add to; set by
#: `record` for the render in this context
_RECORD: contextvars.ContextVar[dict | None] = contextvars.ContextVar(
    "emosaic_record", default=None
)


class _Open(threading.local):
    """Each thread's open spans, innermost last."""

    def __init__(self):
        self.stack: list[span] = []


_OPEN = _Open()


class span:
    """`with span("render.match"): ...` times one stage of a render.

    On exit it adds its wall seconds `s`, its self seconds `self_s` (`s`
    less the time its child spans cover) and a count `n` to
    `info["spans"][name]` of the record `record` opened in this context; with
    no record open it adds nothing. `s` is readable after exit either way.
    While a `torch.profiler` is recording, the span is also a range named
    `emosaic:<name>` on the profiler's clock, nested in its parent span's,
    and, with a record open, appends `[name, start_us, end_us]` to the
    record's `info["timeline"]` when it closes: the range's bounds in
    microseconds of the trace's clock (Unix time, read beside the range's
    own readings), so a child's entry comes before its parent's. With no
    profiler there is no timeline.
    A span measures host time and never synchronises the device: a stage's
    device time is the trace's.
    """

    __slots__ = ("name", "s", "_t0", "_child", "_range", "_start_us")

    def __init__(self, name: str):
        self.name = name
        self.s = 0.0

    def __enter__(self) -> "span":
        torch = sys.modules.get("torch")
        self._range = None
        if torch is not None and torch.autograd._profiler_enabled():
            # a plain op range, not `record_function`'s user annotation:
            # the profiler copies user annotations onto the device's
            # timeline, where readers of device intervals would count them
            # as device work
            self._range = torch._C._profiler._RecordFunctionFast(f"emosaic:{self.name}")
            self._range.__enter__()
            self._start_us = time.time_ns() / 1e3  # beside the range's own reading
        _OPEN.stack.append(self)
        self._child = 0.0
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        self.s = time.perf_counter() - self._t0
        stack = _OPEN.stack
        stack.pop()
        if stack:
            stack[-1]._child += self.s
        rec = _RECORD.get()
        if rec is not None:
            spans = rec.setdefault("spans", {})
            e = spans.get(self.name)
            if e is None:
                e = spans[self.name] = {"s": 0.0, "self_s": 0.0, "n": 0}
            e["s"] += self.s
            e["self_s"] += self.s - self._child
            e["n"] += 1
        if self._range is not None:
            if rec is None:
                self._range.__exit__(*exc)
            else:
                # the range reads its end inside `__exit__`, where the
                # profiler's own recording at times stalls for tens of
                # microseconds on one side of that reading: the midpoint of
                # the readings on either side halves the stall
                close = self._range.__exit__
                t_ns = time.time_ns()
                close(*exc)
                end_us = (t_ns + time.time_ns()) / 2e3
                rec.setdefault("timeline", []).append([self.name, self._start_us, end_us])
        return False


def count(name: str, n: int) -> None:
    """Add `n` to the counter `info[name]` of the record `record` opened in
    this context; with no record open, nothing."""
    rec = _RECORD.get()
    if rec is not None:
        rec[name] = rec.get(name, 0) + n


@contextlib.contextmanager
def record(info: dict):
    """Open `info` as the record of one render: the spans inside this
    context add to `info["spans"]`, under the root span `render`."""
    token = _RECORD.set(info)
    try:
        with span("render"):
            yield info
    finally:
        _RECORD.reset(token)


def get_current_rss_kb() -> int | None:
    """VmRSS from /proc/self/status (main.rs:233-245)."""
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1])
    except OSError:
        return None
    return None


class MemoryMonitor:
    """Background thread sampling peak RSS every 100ms (main.rs:157-216)."""

    def __init__(self):
        self._peak_kb = 0
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def start(self) -> "MemoryMonitor":
        self._thread.start()
        return self

    def _run(self):
        while not self._stop.is_set():
            rss = get_current_rss_kb()
            if rss is not None and rss > self._peak_kb:
                self._peak_kb = rss
            self._stop.wait(0.1)

    def stop(self):
        self._stop.set()

    def peak_mb(self) -> str:
        return f"{self._peak_kb / 1024.0:.1f}" if self._peak_kb else "N/A"


def get_device_memory_stats() -> list[dict] | None:
    """Per-device memory use from torch's CUDA caching allocator.

    /proc RSS cannot see device memory, so the runtime report also
    surfaces the allocator's own counters (current/peak bytes allocated,
    device total). Returns None when torch was not imported or no CUDA
    device is in use, so CPU runs simply omit the section.
    """
    torch = sys.modules.get("torch")
    if torch is None or not torch.cuda.is_available():
        return None
    if not torch.cuda.is_initialized():
        return None
    out = []
    for i in range(torch.cuda.device_count()):
        ms = torch.cuda.memory_stats(i)
        if not ms:
            continue
        in_use = int(ms.get("allocated_bytes.all.current", 0))
        out.append(
            {
                "device": f"cuda:{i} ({torch.cuda.get_device_name(i)})",
                "bytes_in_use": in_use,
                "peak_bytes_in_use": int(ms.get("allocated_bytes.all.peak", in_use)),
                "bytes_limit": int(torch.cuda.get_device_properties(i).total_memory),
            }
        )
    return out or None


def print_runtime_stats(start_time: float, monitor: MemoryMonitor, log=None):
    """main.rs:253-269 (+ device HBM counters, which the CUDA-less
    reference has no analogue for)."""
    log = log or (lambda *a: print(*a, file=sys.stderr))
    total = time.time() - start_time
    log("📊 Runtime Statistics:")
    log(f"   Total execution time: {total:.2f}s")
    if total >= 60.0:
        log(f"   ({int(total // 60)} min {total % 60.0:.1f}s)")
    if total >= 1.0:
        log(f"   Peak memory usage: {monitor.peak_mb()} MB")
        for s in get_device_memory_stats() or []:
            line = (
                f"   Device memory [{s['device']}]: "
                f"peak {s['peak_bytes_in_use'] / 2**20:.1f} MB"
            )
            if s["bytes_limit"]:
                line += f" / {s['bytes_limit'] / 2**20:.0f} MB limit"
            log(line)


class PhaseTimer:
    """Per-phase wall timers printed at exit — the TPU-side analogue of the
    reference's per-stage progress throughput (SURVEY.md section 5
    'tracing/profiling'). Each phase is a `span`, so `--profile` traces
    show it."""

    def __init__(self, log=None):
        self.log = log or (lambda *a: print(*a, file=sys.stderr))
        self.phases: list[tuple[str, float]] = []

    class _Span(span):
        __slots__ = ("timer",)

        def __init__(self, timer, name):
            super().__init__(name)
            self.timer = timer

        def __exit__(self, *exc):
            super().__exit__(*exc)
            self.timer.phases.append((self.name, self.s))
            return False

    def phase(self, name: str) -> "_Span":
        return PhaseTimer._Span(self, name)

    def report(self):
        if not self.phases:
            return
        self.log("⏱  Phase timings:")
        for name, dt in self.phases:
            self.log(f"   {name}: {dt:.2f}s")


class Progress:
    """Minimal throughput progress line (stderr), standing in for the
    reference's indicatif `{msg} {wide_bar} {pos}/{len} ({per_sec})`."""

    def __init__(self, total: int, message: str, interval: float = 1.0):
        self.total = total
        self.message = message
        self.start = time.time()
        self._last = 0.0
        self.interval = interval

    def __call__(self, pos: int, total: int | None = None):
        now = time.time()
        total = total or self.total
        if now - self._last < self.interval and pos < total:
            return
        self._last = now
        rate = pos / max(now - self.start, 1e-9)
        print(
            f"\r{self.message} {pos}/{total} ({rate:.0f}/s)",
            end="\n" if pos >= total else "",
            file=sys.stderr,
        )
