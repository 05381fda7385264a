"""The tiny size of `cli_m32_lib100k` for the tests under `bench_torch/`
(`bench_torch/tests/tiny.py` `TINY`: mode, tile size, tiles, photo height,
photo width), registered here, at the root, so that every test under
`bench_torch/` sees it whichever file is run."""

from bench_torch.tests import tiny

#: cli_m32_lib100k: mode 8, tiles of 8, 300 tiles, 128 x 128 photos (B = 256)
tiny.TINY.setdefault("cli_m32_lib100k", (8, 8, 300, 128, 128))
