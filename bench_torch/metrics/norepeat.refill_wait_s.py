"""Seconds a render the device refill's calls wait on the card
(`info["refill_wait_s"]`: K12's stream synchronisation, or the stripe
route's top-k with its copies to the host), the mean over the window's
renders that hold it; nothing where no render made a refill callback. The
rest of `norepeat.refill` is the call's host work."""

from bench_torch.records import with_callbacks


def read(run):
    rec = with_callbacks(run, "refill_wait_s")
    return sum(i["refill_wait_s"] for i in rec) / len(rec) if rec else None
