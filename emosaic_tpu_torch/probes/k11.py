#!/usr/bin/env python3
"""K11 (`csrc/l2_score.cu`), the exact squared-L2 kernel of the hybrid and
L2 matchers, alone on one GPU, with the routes it serves.

    python3 emosaic_tpu_torch/probes/k11.py [--root DIR] [--label NAME] [--ptxas] [--sass]
                                            [--quick] [--sweep]

`--root` imports `emosaic_tpu_torch` from another checkout (for example a
`git archive` of an earlier commit unpacked into a git-ignored directory),
so two versions are timed by the same script on the same card: run it as
parent, change, change, parent in one call. A checkout without K11 (the
f32 `torch.matmul` routes) has its routes timed only. `--ptxas` prints
ptxas's register, shared-memory and spill report, `--sass` the static
instruction mix of each K11 kernel (`cuobjdump -sass`), `--quick` stops
after the exact checks, `--sweep` times only the argmin entry at 16384 x
65534 rows of 48 to 3072 bytes (where its packed key and its (dist^2,
col) compare trade places).

Where the checkout has K11, it checks both entries against their plain
versions (`_l2_argmin_ref`, `_l2_topcap_ref`) at small shapes (D = 12,
48, 768, 3072 and 49152, every segment length, caps 1 to 32 and, where
the checkout ranks whole segments, caps up to the segment, duplicated
rows, col0 and real_l padding), then times with CUDA events (mean of 5
after a warm-up), on uniform random u8 data:

- the argmin entry at phase H's mode-4 shape, 262144 x 200000 x 48, and
  at the flagship shape, 16384 x 65534 x 3072;
- the top-cap entry at both shapes with the prefilter's plan for k_pre =
  64 (mode 4, k = 1) and 1024 (the flagship's no-repeat, k = 512);
- `_l2_prefilter` (stage 1, stage 2, the fallback) at both shapes and at
  flagship-width rows against a 20000-row library (16384 x 20000 x 3072,
  k_pre = 1024), where no segment keeps its survivors within 1/16;

each beside its bound (2 D operations a score at 1979 TOP/s, or the bytes
in and out at 3.35 TB/s), and samples the SM clock and power while the
mode-4 top-cap runs. Every checkout then times its routes with the host
clock (mean of 2 after a warm-up; each returns host arrays): `l2_argmin`
and `l1_topk_hybrid(k=1)` at the mode-4 shape, `l1_topk_hybrid(k=512,
k_pre=1024)` at the flagship shape and the 20000-row library. The last line of its output is one
JSON object of the numbers, with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

MODE4 = (262144, 200000, 48)
FLAGSHIP = (16384, 65534, 3072)
LIB20K = (16384, 20000, 3072)
SWEEP_D = (48, 96, 192, 384, 768, 1536, 3072)
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


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


def wall_s(torch, fn, reps: int = 2) -> float:
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps


def bound_ms(rows: int, l: int, d: int, out_bytes: int) -> float:
    ops = 2.0 * rows * l * d
    nbytes = rows * d + l * d + out_bytes
    return max(ops / INT8_OPS_PER_S, nbytes / HBM_BYTES_PER_S) * 1e3


def clock_sample(torch, fn, seconds: float = 2.0) -> dict:
    """The SM clock and the power while fn runs back to back."""
    proc = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw", "--format=csv,noheader,nounits",
         "-lms", "200"], stdout=subprocess.PIPE, text=True)
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        fn()
        torch.cuda.synchronize()
    proc.terminate()
    rows = [ln.split(",") for ln in proc.communicate()[0].strip().splitlines() if "," in ln]
    mhz = [float(a) for a, _ in rows]
    watts = [float(b) for _, b in rows]
    return {"sm_mhz": max(mhz), "sm_mhz_min": min(mhz), "power_w": max(watts)} if rows else {}


def ptxas_report(kernel) -> None:
    from emosaic_tpu_torch.ops import _kernels

    r = subprocess.run(
        [_kernels._nvcc(), *_kernels.NVCC_FLAGS, "-Xptxas", "-v", "-o",
         str(_kernels.BUILD_DIR / f"ptxas_{kernel.source_name}.so"), str(kernel.source)],
        capture_output=True, text=True,
    )
    lines = [ln for ln in (r.stdout + r.stderr).splitlines()
             if "registers" in ln or "spill" in ln or "Compiling" in ln or "warning" in ln]
    print("\n".join(lines[-40:]), flush=True)


def sass_mix(lib: Path) -> dict:
    """Static opcode counts of each K11 kernel, {kernel: {opcode: n}}."""
    import re

    from emosaic_tpu_torch.ops._kernels import _nvcc

    tool = Path(_nvcc()).parent / "cuobjdump"
    text = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True, text=True,
                          check=True).stdout
    out = {}
    for part in text.split("Function : ")[1:]:
        name = part.split("\n", 1)[0].strip()
        counts: dict[str, int] = {}
        for m in re.finditer(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)", part):
            counts[m.group(1)] = counts.get(m.group(1), 0) + 1
        out[name] = dict(sorted(counts.items(), key=lambda kv: -kv[1]))
    return out


def check_exact(torch, distance, u8, label: str) -> None:
    n = 0
    ranked = hasattr(distance, "_K11_GROUP_CAP")  # caps above 32
    for r, l, d in [(1, 1, 3), (130, 300, 12), (257, 1000, 48), (300, 513, 768),
                    (100, 600, 3072), (33, 700, 2048), (33, 700, 2050), (20, 300, 49152),
                    (5000, 3000, 48)]:
        x, t = u8((r, d)), u8((l, d))
        t[l // 2 :] = t[: l - l // 2].clone()  # duplicated rows: ties
        got, want = distance._l2_argmin(x, t), distance._l2_argmin_ref(x, t)
        assert all(torch.equal(a, b) for a, b in zip(got, want)), f"argmin {r} {l} {d}"
        n += 1
    for seg in distance._K11_SEGS:
        for d in (12, 48, 768, 3072):
            for storm in (False, True):
                t = u8((4, d)).repeat(750, 1) if storm else u8((3000, d))
                x = u8((70, d))
                x[0] = t[1500]
                for cap in (1, 7, 16, 24, 32) + ((33, 100, 128) if ranked else ()):
                    got = distance.l2_topcap(x, t, cap, seg=seg)
                    want = distance._l2_topcap_ref(x, t, cap, seg, 0, 3000)
                    assert torch.equal(got, want), f"topcap seg {seg} d {d} cap {cap}"
                    n += 1
    x, t = u8((100, 48)), u8((900, 48))
    for col0, real_l in ((1000, 1200), (0, 700), (128, 128)):
        got = distance.l2_topcap(x, t, 8, seg=256, col0=col0, real_l=real_l)
        assert torch.equal(got, distance._l2_topcap_ref(x, t, 8, 256, col0, real_l))
        n += 1
    x, t = u8((40, 49152)), u8((300, 49152))
    assert torch.equal(distance.l2_topcap(x, t, 8, seg=128),
                       distance._l2_topcap_ref(x, t, 8, 128, 0, 300))
    torch.cuda.synchronize()
    print(f"[{label}] K11 exact against its plain versions: {n + 1} cases", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[2]))
    ap.add_argument("--label", default="")
    ap.add_argument("--ptxas", action="store_true")
    ap.add_argument("--sass", action="store_true")
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--sweep", action="store_true")
    args = ap.parse_args(argv)
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    import torch

    if not torch.cuda.is_available():
        print("k11: needs a GPU", file=sys.stderr)
        return 1
    from emosaic_tpu_torch.ops import _kernels, distance

    label = args.label or str(root)
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)

    def u8(shape):
        return torch.randint(0, 256, shape, dtype=torch.uint8, device=dev, generator=gen)

    card = card_line()
    print(f"[{label}] {card}", flush=True)
    out = {"label": label, "card": card}
    has_k11 = hasattr(_kernels, "L2_TOPCAP")
    t0 = time.perf_counter()
    needed = [_kernels.L1_ROWS] + ([_kernels.L2_ARGMIN] if has_k11 else [])  # K3: the rescore
    secs = _kernels.build_all(needed, force=True)
    print(f"[{label}] built {secs} in {time.perf_counter() - t0:.2f} s", flush=True)
    if has_k11:
        if args.ptxas:
            ptxas_report(_kernels.L2_TOPCAP)
        if args.sass:
            for name, counts in sass_mix(_kernels.L2_TOPCAP.library).items():
                total = sum(counts.values())
                top = ", ".join(f"{k} {v}" for k, v in list(counts.items())[:16])
                print(f"[{label}] SASS {name}: {total} instructions; {top}", flush=True)
        check_exact(torch, distance, u8, label)
        if args.quick:
            print(json.dumps(out))
            return 0
        if args.sweep:
            for d in SWEEP_D:
                x, t = u8((16384, d)), u8((65534, d))
                ms = cuda_ms(torch, lambda: distance._l2_argmin(x, t))
                out[f"argmin_d{d}_ms"] = ms
                print(f"[{label}] argmin 16384 x 65534 x D={d}: {ms:.3f} ms [{card}]", flush=True)
                del x, t
            print(json.dumps(out))
            return 0

    shapes = {"mode4": (MODE4, 64), "flagship": (FLAGSHIP, 1024), "lib20k": (LIB20K, 1024)}
    for key, ((b, l, d), k_pre) in shapes.items():
        x, t = u8((b, d)), u8((l, d))
        if has_k11 and key == "lib20k":
            ms = cuda_ms(torch, lambda: distance._l2_prefilter(x, t, k_pre), reps=3)
            out[f"prefilter_{key}_ms"] = ms
            plan = distance._k11_topcap_plan(l, k_pre)
            print(f"[{label}] prefilter {key} {b} x {l} x D={d}, plan {plan}: {ms:.3f} ms "
                  f"[{card}]", flush=True)
        elif has_k11:
            seg, cap = distance._k11_topcap_plan(l, k_pre)
            prep = distance._k11_lib(t)
            nseg = -(-l // seg)
            runs = {
                "argmin": (lambda: distance._l2_argmin(x, t), 8 * b),
                "topcap": (lambda: distance.l2_topcap(x, t, cap, seg=seg, prepared=prep),
                           8 * b * nseg * cap),
                "prefilter": (lambda: distance._l2_prefilter(x, t, k_pre), 4 * b * k_pre),
            }
            for name, (fn, out_bytes) in runs.items():
                ms = cuda_ms(torch, fn, reps=5 if name != "prefilter" else 3)
                bd = bound_ms(b, l, d, out_bytes)
                out[f"{name}_{key}_ms"] = ms
                out[f"{name}_{key}_bound_ms"] = bd
                what = f" seg {seg} cap {cap}" if name == "topcap" else ""
                print(f"[{label}] {name} {key} {b} x {l} x D={d}{what}: {ms:.3f} ms, bound "
                      f"{bd:.3f} ms ({100 * bd / ms:.1f}%) [{card}]", flush=True)
                if name == "topcap" and key == "mode4":
                    clk = clock_sample(torch, fn)
                    out["topcap_mode4_clock"] = clk
                    print(f"[{label}] while it runs: SM clock {clk.get('sm_mhz')} MHz (min "
                          f"{clk.get('sm_mhz_min')}), {clk.get('power_w')} W", flush=True)
            out[f"plan_{key}"] = [seg, cap]
            del prep
        k = 1 if key == "mode4" else 512
        routes = {f"l1_topk_hybrid_{key}_s": lambda k=k, k_pre=k_pre: distance.l1_topk_hybrid(
            x, t, k, k_pre=k_pre)}
        if key == "mode4":
            routes["l2_argmin_mode4_s"] = lambda: distance.l2_argmin(x, t)
        for name, fn in routes.items():
            out[name] = wall_s(torch, fn)
            print(f"[{label}] {name}: {out[name]:.4f} s [{card}]", flush=True)
        del x, t
        torch.cuda.empty_cache()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
