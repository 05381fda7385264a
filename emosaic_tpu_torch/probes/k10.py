#!/usr/bin/env python3
"""K10 (`csrc/l1_topcap.cu`), the exact u8 L1 kernel, alone on one GPU:
its stripe entry (`l1_block` on u8 rows) and its fused top-cap entry
(`l1_topcap`).

    python3 emosaic_tpu_torch/probes/k10.py [--root DIR] [--ptxas] [--sass] [--ncu]
                                            [--vsad] [--label NAME]

`--root` imports `emosaic_tpu_torch` from another checkout (for example a
`git archive` of an earlier commit unpacked into a git-ignored directory),
so two versions are timed by the same script on the same card: run it as
parent, change, change, parent in one call. The kernels of that checkout
are built there, from its own sources. `--ptxas` prints ptxas's register,
shared-memory and spill report of both entries, `--sass` the static
instruction mix of each K10 kernel in the built library (`cuobjdump
-sass`), and `--ncu` runs one launch of each entry at the shapes below
under Nsight Compute (scheduler and warp-state statistics), where the
toolkit has `ncu` and it runs. `--vsad` measures the VABSDIFF4 pipe alone (K1's pure
kernel, `emosaic_vsad_rate` in `csrc/l1_argmin.cu`) at 1, 2, 4 and 8
blocks of 256 threads an SM: whether 8 warps an SM, K10's consumers, can
keep it busy.

It checks both entries against their plain versions (`_l1_block_ref`,
`_l1_topcap_ref`) at small shapes aimed at a persistent, pipelined
kernel (fewer tiles than SMs, a tile count not a multiple of 132, ragged
rows and library, D = 3, 48, 3088, caps 1, 8, 16, 32 and 33, tie storms,
col0 and real_l padding), then times with CUDA events (mean of 5 after a
warm-up):

- the top-cap at the worst case: 16384 x 65534 x 3072, cap 8;
- the stripe at phase N's chunk: [4096, 3072] x [65534, 3072];
- the top-cap at P4's shard: 4096 x 32767 x 48, cap 16, col0 = 32767;
- the stripe at 256 rows of the same library;

each beside its VABSDIFF4 ceiling (the byte pairs at 132 SMs x 64 lanes x
4 byte pairs x the card's maximum SM clock), and samples the SM clock and
power while the worst case runs. The last line of its output is one JSON
object of the numbers, with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
import time
from pathlib import Path

SHAPES = {
    "topcap_wc": (16384, 65534, 3072, 8),
    "stripe_main": (4096, 65534, 3072, None),
    "topcap_p4": (4096, 32767, 48, 16),
    "stripe_256": (256, 65534, 3072, None),
}


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def smi(query: str) -> str:
    return subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader,nounits"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def cuda_ms(torch, fn, reps: int = 5) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def ptxas_report(kernels) -> None:
    from emosaic_tpu_torch.ops import _kernels

    for k in {k.source_name: k for k in kernels}.values():
        r = subprocess.run(
            [_kernels._nvcc(), *_kernels.NVCC_FLAGS, "-Xptxas", "-v", "-o",
             str(_kernels.BUILD_DIR / f"ptxas_{k.source_name}.so"), str(k.source)],
            capture_output=True, text=True,
        )
        lines = [ln for ln in (r.stdout + r.stderr).splitlines()
                 if "registers" in ln or "spill" in ln or "Compiling" in ln
                 or "setmaxnreg" in ln or "warning" in ln]
        print("\n".join(lines[-60:]), flush=True)


def sass_mix(lib: Path, name_part: str) -> dict:
    """Static opcode counts of every kernel whose mangled name holds
    `name_part`, {kernel: {opcode: n}} (most frequent first)."""
    from emosaic_tpu_torch.ops._kernels import _nvcc

    tool = Path(_nvcc()).parent / "cuobjdump"
    text = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True, text=True,
                          check=True).stdout
    out = {}
    for part in text.split("Function : ")[1:]:
        name = part.split("\n", 1)[0].strip()
        if name_part not in name:
            continue
        counts: dict[str, int] = {}
        for m in re.finditer(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)", part):
            counts[m.group(1)] = counts.get(m.group(1), 0) + 1
        out[name] = dict(sorted(counts.items(), key=lambda kv: -kv[1]))
    return out


def ncu_report(root: Path, label: str) -> str:
    """Nsight Compute on one launch of each entry (a child of this script,
    `--ncu-child`); returns its report's tail, or why it did not run."""
    from emosaic_tpu_torch.ops._kernels import _nvcc

    ncu = Path(_nvcc()).parent / "ncu"
    if not ncu.exists():
        return f"no ncu beside nvcc ({ncu.parent})"
    cmd = [str(ncu), "--section", "SchedulerStats", "--section", "WarpStateStats",
           "--section", "InstructionStats", "--section", "Occupancy", "-k", "regex:l1_",
           sys.executable, __file__, "--root", str(root), "--ncu-child", "--label", label]
    try:
        r = subprocess.run(cmd, capture_output=True, text=True, timeout=240)
    except subprocess.TimeoutExpired:
        return "ncu: timed out after 240 s"
    return f"ncu exit {r.returncode}\n" + "\n".join((r.stdout + r.stderr).splitlines()[-160:])


def clock_sample(torch, fn, seconds: float = 2.0) -> dict:
    """SM clock and power sampled by nvidia-smi while fn() runs back to back."""
    proc = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw", "--format=csv,noheader,nounits",
         "-lms", "100"], stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    time.sleep(0.5)
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        fn()
        torch.cuda.synchronize()
    proc.terminate()
    text, _ = proc.communicate()
    mhz, watts = [], []
    for ln in text.splitlines():
        parts = [p.strip() for p in ln.split(",")]
        try:
            mhz.append(float(parts[0]))
            watts.append(float(parts[1]))
        except (ValueError, IndexError):
            continue
    # the samples taken while the kernel ran: the last 3/4
    mhz, watts = mhz[len(mhz) // 4:], watts[len(watts) // 4:]
    if not mhz:
        return {"sm_mhz": None, "power_w": None}
    return {"sm_mhz": sorted(mhz)[len(mhz) // 2], "sm_mhz_min": min(mhz),
            "power_w": sorted(watts)[len(watts) // 2]}


def vsad_by_occupancy(torch, dev, label: str, card: str) -> dict:
    import ctypes

    from emosaic_tpu_torch.ops._kernels import L1_ARGMIN

    L1_ARGMIN.build()
    fn = ctypes.CDLL(str(L1_ARGMIN.library)).emosaic_vsad_rate
    fn.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = torch.zeros(1, dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rates = {}
    for per in (1, 2, 4, 8):
        iters = 16384 // per

        def run():
            if fn(dev.index, out.data_ptr(), sms * per, iters, stream) != 0:
                raise RuntimeError("vsad_rate launch failed")

        ms = cuda_ms(torch, run, reps=3)
        # 256 threads x 8 chains x 16 steps x 4 byte pairs an iteration
        rates[per] = sms * per * 256 * 8 * 16 * iters * 4 / (ms * 1e-3)
        print(f"[{label}] VABSDIFF4 alone at {per} block(s) of 256 threads an SM: "
              f"{rates[per] / 1e12:.2f} T byte pairs/s [{card}]", flush=True)
    return rates


def check_exact(torch, distance, dev, gen, label: str) -> None:
    def u8(shape):
        return torch.randint(0, 256, shape, dtype=torch.uint8, device=dev, generator=gen)

    n = 0
    for r, l, d in [(1, 1, 3), (130, 1000, 48), (300, 700, 3), (129, 257, 3088),
                    (1000, 4000, 48), (257, 129 * 128 + 5, 16), (3, 200, 65800)]:
        x, t = u8((r, d)), u8((l, d))
        got = distance.l1_block(x, t)
        torch.cuda.synchronize()
        if not torch.equal(got, distance._l1_block_ref(x, t)):
            raise AssertionError(f"[{label}] stripe r={r} L={l} D={d}: kernel != plain")
        n += 1
    for r, l, d in [(5, 100, 3), (130, 1000, 48), (700, 9000, 48), (129, 300, 3088)]:
        for kind in ("uniform", "storm"):
            t = u8((4, d)).repeat(-(-l // 4), 1)[:l].contiguous() if kind == "storm" else u8((l, d))
            x = u8((r, d))
            x[0] = t[l // 2]
            for cap in (1, 8, 16, 32, 33):
                for col0, real_l in ((0, l), (1000, 1000 + l - 77)):
                    got = distance.l1_topcap(x, t, cap, col0=col0, real_l=real_l)
                    torch.cuda.synchronize()
                    want = distance._l1_topcap_ref(x, t, cap, col0, real_l)
                    if not torch.equal(got, want):
                        raise AssertionError(f"[{label}] top-cap r={r} L={l} D={d} cap={cap} "
                                             f"{kind} col0={col0}: kernel != plain")
                    n += 1
    print(f"[{label}] K10 exact at {n} check cases", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[2]))
    ap.add_argument("--ptxas", action="store_true")
    ap.add_argument("--sass", action="store_true")
    ap.add_argument("--ncu", action="store_true")
    ap.add_argument("--vsad", action="store_true")
    ap.add_argument("--ncu-child", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--label", default="")
    args = ap.parse_args(argv)
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    import torch

    if not torch.cuda.is_available():
        print("k10: needs a GPU", file=sys.stderr)
        return 1
    from emosaic_tpu_torch.ops import _kernels, distance

    label = args.label or str(root)
    kernels = (_kernels.L1_STRIPE, _kernels.L1_TOPCAP)
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)

    def u8(shape):
        return torch.randint(0, 256, shape, dtype=torch.uint8, device=dev, generator=gen)

    if args.ncu_child:  # one launch of each entry, for Nsight Compute
        b, l, d, cap = SHAPES["topcap_wc"]
        x, t = u8((b, d)), u8((l, d))
        distance.l1_topcap(x, t, cap)
        distance.l1_block(x[:SHAPES["stripe_main"][0]], t)
        torch.cuda.synchronize()
        return 0

    card = card_line()
    print(f"[{label}] {card}", flush=True)
    t0 = time.perf_counter()
    secs = _kernels.build_all(kernels, force=True)
    print(f"[{label}] built {secs} in {time.perf_counter() - t0:.2f} s", flush=True)
    if args.ptxas:
        ptxas_report(kernels)
    out = {"label": label, "card": card}
    if args.sass:
        mix = sass_mix(_kernels.L1_TOPCAP.library, "l1_")
        for name, counts in mix.items():
            total = sum(counts.values())
            top = ", ".join(f"{k} {v}" for k, v in list(counts.items())[:14])
            print(f"[{label}] SASS {name}: {total} instructions; {top}", flush=True)
        out["sass"] = {name: {"total": sum(c.values()),
                              "vabsdiff4_share": c.get("VABSDIFF4", 0) / max(1, sum(c.values())),
                              "top": dict(list(c.items())[:14])} for name, c in mix.items()}
    check_exact(torch, distance, dev, gen, label)
    if args.vsad:
        out["vsad_by_blocks_per_sm"] = vsad_by_occupancy(torch, dev, label, card)

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    mhz = float(smi("clocks.max.sm"))
    rate = sms * 64 * 4 * mhz * 1e6
    out["vabsdiff4_rate"] = rate
    x = u8((16384, 3072))
    t = u8((65534, 3072))
    for key, (r, l, d, cap) in SHAPES.items():
        if d == 3072:
            xs, ts = x[:r], t[:l]
        else:
            xs, ts = u8((r, d)), u8((l, d))
        if cap is None:
            fn = lambda xs=xs, ts=ts: distance.l1_block(xs, ts)  # noqa: E731
        elif key == "topcap_p4":
            fn = lambda xs=xs, ts=ts, cap=cap, l=l: distance.l1_topcap(  # noqa: E731
                xs, ts, cap, col0=l, real_l=2 * l)
        else:
            fn = lambda xs=xs, ts=ts, cap=cap: distance.l1_topcap(xs, ts, cap)  # noqa: E731
        ms = cuda_ms(torch, fn)
        ceil_ms = r * l * d / rate * 1e3
        out[f"{key}_ms"] = ms
        out[f"{key}_ceiling_ms"] = ceil_ms
        print(f"[{label}] {key} {r} x {l} x D={d}" + (f" cap {cap}" if cap else "")
              + f": {ms:.3f} ms, VABSDIFF4 ceiling {ceil_ms:.3f} ms "
              f"({100 * ceil_ms / ms:.1f}%) [{card}]", flush=True)
        if key == "topcap_wc":
            clk = clock_sample(torch, fn)
            out["topcap_wc_clock"] = clk
            print(f"[{label}] while the worst case runs: SM clock {clk['sm_mhz']} MHz "
                  f"(min {clk.get('sm_mhz_min')}; max {mhz:.0f}), {clk['power_w']} W", flush=True)
        del fn, xs, ts
        torch.cuda.empty_cache()
    del x, t
    torch.cuda.empty_cache()
    if args.ncu:
        print(ncu_report(root, label), flush=True)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
