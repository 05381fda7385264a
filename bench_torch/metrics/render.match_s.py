"""Mean seconds a render of `render_nto1`'s match (the `render.match` span:
`match_blocks`, or the top-k and the in-render assignment, with the items'
copy to the host)."""

from bench_torch.spans import per_render


def read(run):
    return per_render(run, "render.match")
