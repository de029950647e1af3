"""`PROFILE_DIR` and `COMPILE_CACHE_DIR` in the port
(menghini_neurips23_tpu_torch/runners/common.py, ops/_cuda.py) on the CPU.

The JAX package wraps a workflow in jax.profiler.trace and points XLA's
persistent compilation cache at COMPILE_CACHE_DIR
(menghini_neurips23_tpu/runners/common.py).  The port writes a
torch.profiler trace under PROFILE_DIR, warns when no new trace appears
(a stale one left by an earlier run does not count), and builds and reuses
its CUDA kernels' libraries under COMPILE_CACHE_DIR/kernels; CUDA graphs
are not kept.
"""

import json
import logging
import os

import pytest

from menghini_neurips23_tpu_torch.ops import _cuda
from menghini_neurips23_tpu_torch.runners import common, main_ssl
from tests.conftest import make_mnist_fixture
from tests.torch_port_fixtures import native_build_outside_checkout  # noqa: F401


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    root = tmp_path_factory.mktemp("profile_data")
    make_mnist_fixture(root / "MNIST")
    return root


def _argv_env(tmp_path, dataset, **extra):
    yml = tmp_path / "tiny.yml"
    yml.write_text(f"EPOCHS: 1\nBATCH_SIZE: 8\nN_LABEL: 2\nARTIFACT_DIR: {tmp_path / 'art'}\n")
    env = dict(OPTIM_SEED="1", VIS_ENCODER="tiny-test", DATASET_NAME="MNIST",
               DATASET_DIR=str(dataset), MODEL="textual_prompt", SPLIT_SEED="500", **extra)
    return ["--model_config", str(yml), "--learning_paradigm", "ssl"], env


def test_main_ssl_with_profile_dir_writes_a_new_trace(tmp_path, dataset, monkeypatch):
    monkeypatch.chdir(tmp_path)
    prof = tmp_path / "prof"
    prof.mkdir()
    stale = prof / "rank0.1.pt.trace.json"
    stale.write_text("{}")
    argv, env = _argv_env(tmp_path, dataset, PROFILE_DIR=str(prof))
    main_ssl.main(argv, env=env, device="cpu")
    new = sorted(set(prof.glob("rank0.*.pt.trace.json")) - {stale})
    assert len(new) == 1
    events = json.loads(new[0].read_text())["traceEvents"]
    names = {e.get("name", "") for e in events}
    # the run's own work is in it: the text tower's matmuls and the prompt's SGD
    assert len(events) > 1000 and any("addmm" in n or "linear" in n for n in names)
    assert (tmp_path / "art").exists()


def test_profiled_warns_when_no_new_trace_appears(tmp_path, monkeypatch, caplog):
    """A stale trace already in the directory does not mask a run that
    wrote none."""
    import torch.profiler

    (tmp_path / "rank0.1.pt.trace.json").write_text("{}")
    monkeypatch.setattr(torch.profiler, "tensorboard_trace_handler",
                        lambda *a, **k: (lambda prof: None))
    with caplog.at_level(logging.WARNING, logger=common.log.name):
        assert common.profiled(lambda: 7, str(tmp_path), "cpu") == 7
    assert f"PROFILE_DIR={tmp_path}: torch.profiler wrote no trace" in caplog.text


def test_compile_cache_dir_holds_and_reuses_the_kernel_libraries(tmp_path, dataset, monkeypatch):
    """Under COMPILE_CACHE_DIR the libraries resolve to <dir>/kernels; a
    second run resolves the same file and finds it built (no nvcc here: the
    library is a stand-in file, which `build` takes as built)."""
    monkeypatch.chdir(tmp_path)
    argv, env = _argv_env(tmp_path, dataset, COMPILE_CACHE_DIR="cache")
    names = ("attention_fwd", "attention_bwd", "clip_head")

    def first(*a, **k):
        paths = [_cuda.library_path(n) for n in names]
        for p in paths:
            os.makedirs(os.path.dirname(p), exist_ok=True)
            open(p, "wb").close()
        return paths

    def second(*a, **k):
        return [_cuda.library_path(n) for n in names], _cuda.build(names)

    paths = common.main_template(first, argv=argv, env=env, device="cpu")
    assert all(p.startswith(str(tmp_path / "cache" / "kernels") + os.sep) for p in paths)
    again, seconds = common.main_template(second, argv=argv, env=env, device="cpu")
    assert again == paths and seconds == {n: 0.0 for n in names}
    assert _cuda.build_dir() == _cuda.BUILD_DIR
    assert all(not p.startswith(_cuda.BUILD_DIR) for p in paths)
