"""Mean seconds a render of the composite (the `render.compose` span: the
tile stack to the card, K2, the image to the host)."""

from bench_torch.spans import per_render


def read(run):
    return per_render(run, "render.compose")
