"""Mean seconds a render of the in-render no-repeat engine (the
`sequence.engine` span: the blocks in render order over their lists, with
the engine's host masked scans where a list runs dry)."""

from bench_torch.spans import per_render


def read(run):
    return per_render(run, "sequence.engine")
