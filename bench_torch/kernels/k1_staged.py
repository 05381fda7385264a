"""K1's staged path, `csrc/l1_argmin.cu` `l1_argmin_staged` (rows wider than
64 bytes, 128 x 128 tiles, 8 x 8 micro-tiles a thread), with the key kernels
of its launch (key init, key unpack). Work and bytes are `kernels/k1.py`'s:
2 ops a byte pair of every distinct block against every library row, at the
int8 peak. Its reachable ceiling is the VABSDIFF4 rate, 6.76% of that peak
(4 byte pairs a lane a clock on 132 SMs x 64 lanes at 1980 MHz)."""

PATTERN = r"\b(l1_argmin_staged|init_keys|unpack_keys)\b"


def work(run):
    return run.kernel("k1").work(run)
