"""The port's CUDA kernel loader (`emosaic_tpu_torch.ops._kernels`).

The kernels compile only where `nvcc` and a GPU exist; these tests cover
what a CPU host can check: the build command, the missing-compiler
error, and the launch wrapper's error path and counter.
"""

import ctypes

import pytest

from emosaic_tpu_torch.ops import _kernels


def test_nvcc_flags_target_hopper():
    assert _kernels.NVCC_FLAGS == [
        "-gencode", "arch=compute_90a,code=sm_90a",
        "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    ]
    for k in _kernels.KERNELS:
        assert k.source.exists(), k.source
        assert k.library.parent == _kernels.BUILD_DIR


def test_missing_nvcc_is_a_clear_error(monkeypatch, tmp_path):
    monkeypatch.setattr(_kernels.shutil, "which", lambda name: None)
    monkeypatch.setattr(_kernels, "Path", lambda p: tmp_path / "no-nvcc")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _kernels._nvcc()


def test_launch_raises_on_a_cuda_error_and_does_not_count():
    k = _kernels.CudaKernel("l1_argmin", "emosaic_l1_argmin", [ctypes.c_int])
    k._fn = lambda *a: 9
    k._err = lambda code: b"invalid configuration argument"
    with pytest.raises(RuntimeError, match="invalid configuration argument"):
        k.launch(0)
    assert k.launches == 0
    k._fn = lambda *a: 0
    k.launch(0)
    assert k.launches == 1
