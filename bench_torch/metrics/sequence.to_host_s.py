"""Mean seconds a render of the in-render no-repeat render's copy of the
blocks and the library to the host (the `sequence.to_host` span: what the
engine's host masked scan reads where a list runs dry)."""

from bench_torch.spans import per_render


def read(run):
    return per_render(run, "sequence.to_host")
