"""Mean seconds a render of the exact-full scorer's dense matrix (the
`scoring.dense` span: `l1_dist_matrix`, K10's stripes and the [B, L] int32
matrix's copy to the host)."""

from bench_torch.spans import per_render


def read(run):
    return per_render(run, "scoring.dense")
