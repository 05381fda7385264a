"""Mean seconds a render of the exact-full scorer's host sort (the
`scoring.sort` span: the stable argsort of the [B, L] matrix, the gather
of its distances and the int32 casts)."""

from bench_torch.spans import per_render


def read(run):
    return per_render(run, "scoring.sort")
