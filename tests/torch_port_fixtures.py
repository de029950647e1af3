"""Fixtures shared by the port's CPU tests (tests/test_torch_port_*.py).

`native_build_outside_checkout` sends the port's native C++ builds
(menghini_neurips23_tpu_torch/data/_native.py, build/native/ at the
repository root by default) into a temporary directory, so that a test run
writes nothing into the checkout.  A test file takes it by importing it.

`l14_grid_runtimes` is a (JAX, port) pair of CPU runtimes on the same
weights of L14_GRID: ViT-L/14's patch grid (224 px / 14 = 256 patches) at
the tiny-test widths, two vision layers and one text layer, registered in
both packages' ARCHS while the fixture lives.  VPT's 16-token prefix makes
its vision sequence 1 + 256 + 16 = 273 tokens and UPT's 4-token prompt 261:
the lengths the attention backward tiles on the card.

`mm_3xtf32` and `mm_1xtf32` emulate the attention kernels' fp32 products on
the tensor cores (tests/test_torch_port_streamed.py, test_torch_port_twophase.py):
each operand x split on its bit pattern into hi (x rounded to TF32's 10
fraction bits, to nearest, ties away from zero, as cvt.rna.tf32.f32 rounds)
and lo (x - hi cut to TF32), and lo.hi + hi.lo + hi.hi summed in fp32; or
one product of both operands rounded to TF32.
"""

import dataclasses

import numpy as np
import pytest
import torch

from menghini_neurips23_tpu_torch.data import _native

L14_GRID = "tiny-l14-grid"


def _tf32_hi(x):
    """x rounded to TF32 (10 fraction bits), to nearest, ties away from zero,
    on the fp32 bit pattern."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _tf32_cut(x):
    """x cut to TF32: the bits a tensor core reads of an fp32 operand."""
    return (x.contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def _split(x):
    hi = _tf32_hi(x)
    return hi, _tf32_cut(x - hi)


def mm_3xtf32(a, b):
    """a @ b as the kernels form it: lo.hi + hi.lo + hi.hi, in fp32."""
    (ah, al), (bh, bl) = _split(a), _split(b)
    return torch.matmul(al, bh) + torch.matmul(ah, bl) + torch.matmul(ah, bh)


def mm_1xtf32(a, b):
    """a @ b from one TF32 product: both operands rounded to TF32."""
    return torch.matmul(_tf32_hi(a), _tf32_hi(b))


@pytest.fixture(scope="module", autouse=True)
def native_build_outside_checkout(tmp_path_factory):
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(_native, "_BUILD_DIR", str(tmp_path_factory.mktemp("native")))
        yield


@pytest.fixture(scope="module")
def l14_grid_runtimes(tmp_path_factory):
    from menghini_neurips23_tpu.config import Config as JaxConfig
    from menghini_neurips23_tpu.models import configs as jax_configs
    from menghini_neurips23_tpu.runtime import ClipRuntime as JaxClipRuntime
    from menghini_neurips23_tpu_torch.config import Config
    from menghini_neurips23_tpu_torch.models import configs
    from menghini_neurips23_tpu_torch.runtime import ClipRuntime
    from tests.test_torch_parity import _make_state_dict

    grid = dict(name=L14_GRID, image_resolution=224, vision_patch_size=14, transformer_layers=1)
    jarch = dataclasses.replace(jax_configs.TINY_TEST, **grid)
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(jax_configs.ARCHS, L14_GRID, jarch)
        mp.setitem(configs.ARCHS, L14_GRID, dataclasses.replace(configs.TINY_TEST, **grid))
        sd = _make_state_dict(jarch, np.random.default_rng(17))
        path = tmp_path_factory.mktemp("ckpt") / "l14_grid_openai.pt"
        torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, path)
        jax_rt = JaxClipRuntime(JaxConfig(VIS_ENCODER=L14_GRID, BATCH_SIZE=8, CLIP_CKPT=str(path)))
        port_rt = ClipRuntime(Config(VIS_ENCODER=L14_GRID, BATCH_SIZE=8, CLIP_CKPT=str(path)),
                              device="cpu")
        assert jax_rt.arch.name == port_rt.arch.name == L14_GRID
        assert port_rt.arch.num_patches == 256
        yield jax_rt, port_rt
