"""K1, `csrc/l1_argmin.cu`: the exact L1 argmin of the repeat match. Its
launch runs the source's three kernels (key init, the argmin core, key
unpack). Work: |x - t| and an add per byte pair of every distinct block
against every library row, at the int8 peak; bytes: the distinct blocks
and the library read once, a distance and a row written per block."""

PATTERN = r"\b(l1_argmin_reg|l1_argmin_staged|init_keys|unpack_keys)\b"


def work(run):
    sz = run.sizes
    rows = sum(run.distinct_blocks(i) for i in run.traced_sources) / len(run.traced_sources)
    ops = 2 * rows * sz["L"] * sz["D"]
    nbytes = rows * sz["D"] + sz["L"] * sz["D"] + rows * 8
    return ops, nbytes, "int8_ops_per_s"
