"""Mean seconds a render of the item grid and its statistics on the host
(the `render.stats` span: `RenderStats.from_grid` in `finish_render`)."""

from bench_torch.spans import per_render


def read(run):
    return per_render(run, "render.stats")
