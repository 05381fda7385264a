"""K9, `csrc/coarse_topcap.cu`: the adaptive scorer's coarse pass, group-sum
projections of every block against every library row with each segment's
least keys selected. Work: a difference and an absolute add per
(block, row, coordinate), 2 flops, at the FP32 peak, over the coordinates
the scorer's plan projects to (`ops/distance.py` `_ad_plan`, copied);
bytes: the projected blocks and library read once, the survivor keys and
each block's bound written once."""

SEG = 128
GROUPS = (32, 16, 8, 4)
PATTERN = r"\bcoarse_topcap_kernel\b"


def plan(d: int, l: int) -> tuple[int, int, int]:
    """(dout, nseg, cap) of the adaptive scorer at row width d, l rows."""
    chan = d % 3 == 0
    nc = d // 3 if chan else d
    per = 3 if chan else 1
    g = next(g for g in GROUPS if nc % g == 0 and (nc // g) * per >= 4)
    nseg = -(-l // SEG)
    return nc // g * per, nseg, 8 if nseg > 1024 else 16


def work(run):
    sz = run.sizes
    b, l = sz["B"], sz["L"]
    dout, nseg, cap = plan(sz["D"], l)
    ops = 2 * b * l * dout
    nbytes = 4 * (b * dout + nseg * SEG * dout + nseg * SEG + b) + 8 * b * nseg * cap
    return ops, nbytes, "fp32_flops_per_s"
