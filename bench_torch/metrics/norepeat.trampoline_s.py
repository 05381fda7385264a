"""Seconds a render of the refill callback's crossing from the native
engine into Python and back: the wall around its calls as the engine sees
it (`info["engine_cb_s"]`) less the `norepeat.refill` spans inside them
(each `DeviceRefiller` call), the mean over the window's renders that hold
the engine's counters; nothing where no render made a refill callback."""

from bench_torch.records import with_callbacks


def _refill_s(info) -> float:
    return info.get("spans", {}).get("norepeat.refill", {}).get("s", 0.0)


def read(run):
    rec = with_callbacks(run, "engine_cb_s")
    return sum(i["engine_cb_s"] - _refill_s(i) for i in rec) / len(rec) if rec else None
