"""Mean seconds a render of the tile stack's way to the card (the
`compose.stack` span inside `render.compose`, `ops/composite.py`
`compose_mosaic`: `augment_stack2d`, the stack's upload and its mirrors);
a program without the span gives nothing."""

from bench_torch.spans import per_render


def read(run):
    return per_render(run, "compose.stack")
