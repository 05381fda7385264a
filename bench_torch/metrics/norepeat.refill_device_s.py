"""Mean seconds a render of the no-repeat assignment's device refills (the
`norepeat.refill` spans: each `DeviceRefiller` call that reaches the card,
its gathers, K10's stripe, the top-k and the copy back)."""

from bench_torch.spans import per_render


def read(run):
    return per_render(run, "norepeat.refill")
