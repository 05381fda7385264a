"""The port's `parallel/` across real processes, on the CPU.

`tests/test_torch_parallel.py` holds the sharded routes on a virtual mesh
in one process; here two OS processes of four virtual CPU shards each
join one 8-position mesh over `torch.distributed` (gloo), so every
exchange of partial results and every ring hop crosses a process
boundary, as `tools/cpu_multiproc_dryrun.py` does for the JAX package.
The ranks import no jax; the parent holds both ranks' arrays against the
JAX package's single-device oracles and against each other. Also the
CLI under EMOSAIC_DISTRIBUTED=1 on two ranks: rank 0's PNG equals the JAX
CLI's single-process output, and rank 1 stands down.

A rank is this file run as a script:
    python tests/test_torch_distributed.py --child RANK INIT_URL OUT.npz
"""

import os
import shutil
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
N_RANKS = 2
TIMEOUT_S = 240


def _inputs():
    """The ranks' (and the oracles') inputs, the same in every process."""
    rng = np.random.default_rng(7)
    blocks = rng.integers(0, 256, size=(131, 12), dtype=np.uint8)
    lib = rng.integers(0, 256, size=(194, 12), dtype=np.uint8)
    lib[50] = lib[3]  # ties across shards and across processes
    blocks[7] = lib[3]
    d, l = 48, 9000
    bases = rng.integers(0, 256, size=(50, d))
    ad_lib = np.clip(
        np.repeat(bases, l // 50, axis=0) + rng.integers(-5, 6, size=(l, d)), 0, 255
    ).astype(np.uint8)
    ad_blocks = np.clip(
        ad_lib[rng.integers(0, l, size=300)].astype(np.int32)
        + rng.integers(-3, 4, size=(300, d)), 0, 255,
    ).astype(np.uint8)
    tiles = rng.integers(0, 256, size=(32, 4, 4, 3), dtype=np.uint8)
    src = rng.integers(0, 256, size=(16, 12, 3), dtype=np.uint8)
    lut_lib = rng.integers(0, 256, size=(300, 3), dtype=np.uint8)
    lut_lib[250] = lut_lib[7]
    big_lib = rng.integers(0, 256, size=(3000, 48), dtype=np.uint8)
    big_blocks = rng.integers(0, 256, size=(9, 48), dtype=np.uint8)
    return dict(blocks=blocks, lib=lib, ad_blocks=ad_blocks, ad_lib=ad_lib, tiles=tiles,
                src=src, lut_lib=lut_lib, big_lib=big_lib, big_blocks=big_blocks)


def _child(rank: int, init: str, out: str) -> None:
    sys.path.insert(0, str(ROOT))
    import torch

    torch.set_num_threads(2)
    from emosaic_tpu_torch.ops import distance
    from emosaic_tpu_torch.parallel import (
        make_mesh,
        sharded_build_l1_lut,
        sharded_l1_argmin,
        sharded_l1_argmin_ring,
        sharded_l1_topk,
        sharded_l1_topk_adaptive,
        sharded_mosaic_step,
    )
    from emosaic_tpu_torch.parallel.distributed import (
        fetch,
        init_distributed,
        is_multiprocess,
        is_rank0,
        world,
    )

    init_distributed(init, N_RANKS, rank)
    first = world()
    init_distributed(init, N_RANKS, rank)  # a second call does nothing
    assert world() is first and is_multiprocess() and is_rank0() == (rank == 0)
    mesh = make_mesh(8, model=2, devices=[torch.device("cpu")] * 8)
    assert mesh.local_positions() == list(range(4 * rank, 4 * rank + 4))
    x = _inputs()
    res = {}
    res["argmin_d"], res["argmin_r"] = sharded_l1_argmin(x["blocks"], x["lib"], mesh)
    res["ring_d"], res["ring_r"] = sharded_l1_argmin_ring(x["blocks"], x["lib"], mesh)
    res["topk_d"], res["topk_r"] = sharded_l1_topk(x["blocks"], x["lib"], 7, mesh)
    st = {}
    res["ad_d"], res["ad_r"] = sharded_l1_topk_adaptive(
        x["ad_blocks"], x["ad_lib"], 4, mesh, stats=st)
    assert st["route"] == "adaptive", st
    res["step"] = sharded_mosaic_step(x["tiles"], x["src"], mesh, 2, 4)
    res["lut"] = sharded_build_l1_lut(x["lut_lib"], mesh)
    # past the device budget: host banks stream through the sharded scorer
    saved = distance.DEVICE_LIB_BYTES_MAX
    distance.DEVICE_LIB_BYTES_MAX = 1024 * 48
    try:
        st = {}
        res["big_d"], res["big_r"] = sharded_l1_topk_adaptive(
            x["big_blocks"], x["big_lib"], 3, mesh, stats=st)
        assert st["route"] == "streamed", st
    finally:
        distance.DEVICE_LIB_BYTES_MAX = saved
    # fetch: each rank's tensor is its row slice of one array
    res["fetch"] = fetch(torch.arange(3 * rank, 3 * rank + 3, dtype=torch.int32))
    assert fetch(res["fetch"]) is res["fetch"]
    res["exchanges"] = np.array(world().exchanges["gloo"])
    assert "jax" not in sys.modules and "emosaic_tpu" not in sys.modules
    np.savez(out, **res)
    print(f"[rank {rank}] done", flush=True)


def _child_env(tmp_path: Path) -> dict:
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")}
    env["PYTHONPATH"] = os.pathsep.join(filter(None, [str(ROOT), env.get("PYTHONPATH")]))
    env["OMP_NUM_THREADS"] = "2"
    env["XDG_CACHE_HOME"] = str(tmp_path / "xdg")
    env["EMOSAIC_PREP_WORKERS"] = "0"
    return env


def _run_ranks(cmds, env, cwd) -> list:
    """Start one process per command, wait for each within TIMEOUT_S (a
    hung rank fails the test, and every rank is killed)."""
    procs = [subprocess.Popen(c, env=env, cwd=cwd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for c in cmds]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r}:\n{out[-4000:]}"
    return outs


def test_two_ranks_bit_identical(tmp_path):
    """2 processes x 4 CPU shards: the five entry points, the LUT and
    `fetch` equal the JAX single-device oracles in both ranks, and the
    ranks agree byte for byte."""
    import jax

    from emosaic_tpu.ops import distance as jdd
    from emosaic_tpu.ops.analysis import analyse_batch, source_blocks
    from emosaic_tpu.ops.composite import compose_mosaic
    from emosaic_tpu.ops.lut import build_l1_lut

    init = f"file://{tmp_path / 'rendezvous'}"
    outs = _run_ranks(
        [[sys.executable, str(Path(__file__).resolve()), "--child", str(r), init,
          str(tmp_path / f"rank{r}.npz")] for r in range(N_RANKS)],
        _child_env(tmp_path), tmp_path,
    )
    for r, out in enumerate(outs):
        assert f"[rank {r}] done" in out
        assert "CUDA partials go over gloo" in out  # the route, logged once
    got = [dict(np.load(tmp_path / f"rank{r}.npz")) for r in range(N_RANKS)]
    assert got[0].keys() == got[1].keys()
    for k in got[0]:
        np.testing.assert_array_equal(got[0][k], got[1][k], err_msg=k)
    g = got[0]
    x = _inputs()
    d, r = jdd.l1_argmin_xla(x["blocks"], x["lib"])
    for name in ("argmin", "ring"):
        np.testing.assert_array_equal(g[f"{name}_d"], np.asarray(d))
        np.testing.assert_array_equal(g[f"{name}_r"], np.asarray(r))
    for name, bl, lb, k in (("topk", "blocks", "lib", 7), ("ad", "ad_blocks", "ad_lib", 4),
                            ("big", "big_blocks", "big_lib", 3)):
        d, r = jdd.l1_topk_stripes(x[bl], x[lb], k)
        np.testing.assert_array_equal(g[f"{name}_d"], np.asarray(d))
        np.testing.assert_array_equal(g[f"{name}_r"], np.asarray(r))
    pal = np.asarray(analyse_batch(x["tiles"], 2))
    _, rows = jdd.l1_argmin_xla(np.asarray(source_blocks(x["src"], 2)),
                                np.asarray(jdd.build_library(pal)))
    items = np.asarray(jdd.rows_to_items(rows, 32)).reshape(8, 6)
    np.testing.assert_array_equal(g["step"], np.asarray(compose_mosaic(items, x["tiles"])))
    np.testing.assert_array_equal(g["lut"], np.asarray(jax.device_get(build_l1_lut(x["lut_lib"]))))
    np.testing.assert_array_equal(g["fetch"], np.arange(6, dtype=np.int32))
    assert int(g["exchanges"]) > 0


def test_distributed_cli_rank0_writes_bit_identical(tmp_path, rng, monkeypatch):
    """EMOSAIC_DISTRIBUTED=1 with EMOSAIC_COORDINATOR: two CLI ranks on a
    2-position CPU mesh (`--mesh auto`), both compute, rank 0 alone
    writes, and its PNG equals the JAX CLI's plain single-process run."""
    from PIL import Image

    from emosaic_tpu import cli as jax_cli

    scene = tmp_path / "scene"
    tiles = scene / "tiles"
    tiles.mkdir(parents=True)
    for i in range(12):
        base = rng.integers(0, 256, size=3)
        arr = np.clip(base + rng.normal(0, 25, (24, 24, 3)), 0, 255).astype(np.uint8)
        Image.fromarray(arr).save(tiles / f"t{i}.jpg", quality=92)
    Image.fromarray(rng.integers(0, 256, size=(10, 13, 3), dtype=np.uint8)).save(
        scene / "src.png")
    args = ["-s", "8", "src.png", "mosaic", "tiles", "-m", "1"]
    shutil.copytree(scene, tmp_path / "jax")
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    env = _child_env(tmp_path)
    cmds = []
    for r in range(N_RANKS):
        cmds.append(["env", "EMOSAIC_DISTRIBUTED=1", f"EMOSAIC_COORDINATOR=localhost:{port}",
                     f"EMOSAIC_NUM_PROCESSES={N_RANKS}", f"EMOSAIC_PROCESS_ID={r}",
                     sys.executable, "-m", "emosaic_tpu_torch.cli", "-o", "dist.png", *args,
                     "--mesh", "auto", "--device", "cpu"])
    outs = _run_ranks(cmds, env, scene)
    assert "Matching on a 2x1 (data x model) device mesh" in outs[0]
    assert "rank 0 writes the outputs" in outs[1] and "rank 0 writes" not in outs[0]
    assert (scene / "dist.png").exists() and (scene / "dist.stats.png").exists()
    monkeypatch.chdir(tmp_path / "jax")
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "xdg-jax"))
    monkeypatch.setenv("EMOSAIC_PREP_WORKERS", "0")
    assert jax_cli.main(["-o", "solo.png", *args]) == 0
    for name in ("dist.png", "dist.stats.png"):
        with Image.open(scene / name) as a, Image.open(
                tmp_path / "jax" / name.replace("dist", "solo")) as b:
            np.testing.assert_array_equal(np.asarray(a.convert("RGB")),
                                          np.asarray(b.convert("RGB")))


def test_fetch_single_process_passthrough():
    """fetch() passes a host array through and copies a tensor to the host
    when no process group is up."""
    import torch

    from emosaic_tpu_torch.parallel.distributed import fetch

    a = np.arange(6).reshape(2, 3)
    assert fetch(a) is a
    t = torch.arange(6).reshape(2, 3)
    got = fetch(t)
    np.testing.assert_array_equal(got, a)
    got[0, 0] = 99
    assert int(t[0, 0]) == 0  # a copy


def test_init_distributed_no_cluster_is_noop(monkeypatch):
    """Without a cluster environment or EMOSAIC_DISTRIBUTED,
    init_distributed leaves the process single."""
    import torch.distributed as dist

    from emosaic_tpu_torch.parallel.distributed import (
        init_distributed,
        is_multiprocess,
        is_rank0,
    )

    for k in ("EMOSAIC_COORDINATOR", "EMOSAIC_NUM_PROCESSES", "EMOSAIC_PROCESS_ID",
              "EMOSAIC_DISTRIBUTED", "RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    init_distributed()
    init_distributed()
    assert not dist.is_initialized() and not is_multiprocess() and is_rank0()


if __name__ == "__main__" and sys.argv[1:2] == ["--child"]:
    _child(int(sys.argv[2]), sys.argv[3], sys.argv[4])
