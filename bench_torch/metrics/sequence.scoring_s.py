"""Mean seconds a render of the in-render no-repeat render's scoring (the
`sequence.scoring` span: the exact top-k lists of every block, on the
card, and their copy to the host)."""

from bench_torch.spans import per_render


def read(run):
    return per_render(run, "sequence.scoring")
