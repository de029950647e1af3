"""The port's data parallelism (menghini_neurips23_tpu_torch/parallel/) on
the CPU: the helpers against the JAX package's, and whole workflows in
spawned gloo process groups against one-process runs.

The JAX package's tests/test_multihost_workflow.py spawns its process groups
the same way.  Each group here has two ranks, each a `main_*` process of the
port launched with torchrun's variables (RANK, WORLD_SIZE, LOCAL_RANK,
MASTER_ADDR, MASTER_PORT) and `device="cpu"`, so it joins a gloo group.  The
ranks split every batch - the frozen passes' decode and encode, and every
training step - and all-reduce the gradients, so a group agrees with one
process up to the order of the gradient sums:

- pseudolabel pickles, artifact file names and result keys are byte for
  byte a one-process run's (the zero-shot pass is gathered exactly; a
  refresh ranks the pool with prompts that differ in rounding only);
- prompts and evaluation logits agree within 1e-4, the port's workflow
  parity tolerance (tests/test_torch_port_train.py), and predictions are
  the same;
- a group killed after an IFPL iteration (MNT_FAIL_AFTER_ITER) or a
  whole-run trainer chunk (MNT_FAIL_AFTER_CHUNK) and started again resumes
  at the same point and ends byte-identical to an uninterrupted group.

Each process runs its torch on one thread, and the one-process run beside
its group: the file stays within a couple of minutes of one worker.
"""

import json
import logging
import os
import pickle
import socket
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from menghini_neurips23_tpu.models import TINY_TEST as JAX_TINY
from menghini_neurips23_tpu.parallel.mesh import pad_to_multiple as jax_pad_to_multiple
from menghini_neurips23_tpu.parallel.multihost import (
    shard_filelist_for_batch as jax_shard_filelist_for_batch,
)
from menghini_neurips23_tpu_torch.config import Config
from menghini_neurips23_tpu_torch.parallel import (
    Mesh,
    data_parallelism,
    mesh_from_config,
    pad_to_multiple,
    shard_filelist_for_batch,
)
from menghini_neurips23_tpu_torch.utils import logging as port_logging
from tests.conftest import make_mnist_fixture
from tests.test_torch_parity import _make_state_dict

REPO = Path(__file__).resolve().parents[1]
TIMEOUT_S = 300  # per process; a group's ranks wait for each other

RUNNER = textwrap.dedent(
    """
    import sys
    import torch
    torch.set_num_threads(1)
    from menghini_neurips23_tpu_torch.runners import main_ssl, main_trzsl, main_ul
    paradigm = sys.argv[2]
    runner = {"ssl": main_ssl, "trzsl": main_trzsl, "ul": main_ul}[paradigm]
    runner.main(["--model_config", sys.argv[1], "--learning_paradigm", paradigm],
                device="cpu")
    """
)


# ------------------------------------------------------------------ helpers
@pytest.mark.parametrize("n, multiple", [(0, 4), (5, 4), (8, 4), (7, 1), (3, 8)])
@pytest.mark.parametrize("trailing", [(), (3, 2)], ids=["1d", "3d"])
def test_pad_to_multiple_matches_jax(n, multiple, trailing):
    arr = np.arange(n * int(np.prod(trailing)), dtype=np.float32).reshape((n,) + trailing)
    got, got_n = pad_to_multiple(arr, multiple, fill=-1)
    want, want_n = jax_pad_to_multiple(arr, multiple, fill=-1)
    assert got_n == want_n == n
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n_files, per_host", [(32, 16), (30, 16), (17, 9), (5, 4), (0, 4),
                                               (10, 3)])
def test_shard_filelist_for_batch_matches_jax(n_files, per_host):
    """Every rank's block, the JAX function called with an explicit
    process_index and no group: host-major, truncated, never equalized."""
    files = [f"f{i}.png" for i in range(n_files)]
    blocks = []
    for pi in range(4):
        got = shard_filelist_for_batch(files, per_host, process_index=pi)
        assert got == jax_shard_filelist_for_batch(files, per_host, process_index=pi)
        blocks += got
    assert blocks == files[: 4 * per_host]


def test_mesh_from_config_reads_mesh_shape():
    """Outside a group the world is one rank: "" and "1" (and "1,1") are a
    one-rank data mesh; "2" asks for ranks the group does not have, and so
    do "2,2" (four: 2 data x 2 model) and "1,2"; a model axis that does not
    divide both towers' head counts is refused, naming them (tiny-test has
    one vision head and two text heads)."""
    from menghini_neurips23_tpu_torch.models import TINY_TEST
    from menghini_neurips23_tpu_torch.parallel.mesh import check_model_axis

    for spec in ("", "1", " 1 ", "1,1"):
        mesh = mesh_from_config(Config(MESH_SHAPE=spec))
        assert mesh == Mesh(data=1) and mesh.shape == {"data": 1, "model": 1}
        assert data_parallelism(mesh) == 1 == data_parallelism()
    with pytest.raises(ValueError, match="asks for 2 data ranks, but the process group has 1"):
        mesh_from_config(Config(MESH_SHAPE="2"))
    with pytest.raises(ValueError, match=r"asks for 4 ranks \(2 data x 2 model\), but the "
                                         "process group has 1"):
        mesh_from_config(Config(MESH_SHAPE="2,2"))
    with pytest.raises(ValueError, match=r"asks for 2 ranks \(1 data x 2 model\)"):
        mesh_from_config(Config(MESH_SHAPE="1,2"))
    with pytest.raises(ValueError, match="1 vision heads and 2 text heads"):
        check_model_axis(2, TINY_TEST)
    for bad in ("x", "0", "1,2,3"):
        with pytest.raises(ValueError, match="MESH_SHAPE"):
            mesh_from_config(Config(MESH_SHAPE=bad))


@pytest.mark.parametrize("rank, emitted", [(0, True), (1, False)])
def test_main_process_handler_emits_on_rank_0_only(monkeypatch, rank, emitted):
    import io

    stream = io.StringIO()
    handler = port_logging.MainProcessHandler(stream)
    logger = logging.getLogger("test_torch_port_parallel.handler")
    logger.addHandler(handler)
    try:
        port_logging.set_process_rank(rank)
        logger.warning("from rank %d", rank)
    finally:
        port_logging.set_process_rank(None)
        logger.removeHandler(handler)
    assert (f"from rank {rank}" in stream.getvalue()) == emitted


@pytest.mark.parametrize("env, main", [
    ({}, True), ({"RANK": "1"}, True), ({"RANK": "1", "WORLD_SIZE": "2"}, False),
    ({"RANK": "0", "WORLD_SIZE": "2"}, True), ({"RANK": "1", "LOCAL_RANK": "1"}, False),
])
def test_rank_before_the_group_comes_from_the_launcher(monkeypatch, env, main):
    """Before the group forms, RANK counts only beside a sign of a
    multi-process launch: a stale RANK=1 alone does not mute a run."""
    for var in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "SLURM_NTASKS", "OMPI_COMM_WORLD_SIZE"):
        monkeypatch.delenv(var, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    port_logging.set_process_rank(None)
    assert port_logging.is_main_process() == main


# ---------------------------------------------------------- process groups
@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    root = tmp_path_factory.mktemp("parallel_data")
    make_mnist_fixture(root / "MNIST")
    return root


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    # seed 16, as the port's other workflow tests: free of near-ties there
    sd = _make_state_dict(JAX_TINY, np.random.default_rng(16))
    path = tmp_path_factory.mktemp("parallel_ckpt") / "tiny_openai.pt"
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, path)
    return str(path)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _start(tmp_path, tag, n_procs, dataset, ckpt, model, paradigm, cfg, env_overrides):
    """Start one run of `n_procs` processes (1: no group) in its own
    artifact directory; returns (artifact dir, processes)."""
    run_dir = tmp_path / tag
    run_dir.mkdir(parents=True, exist_ok=True)
    art = run_dir / "artifacts"
    yml = run_dir / "tiny.yml"
    yml.write_text("".join(f"{k}: {v}\n" for k, v in {**cfg, "ARTIFACT_DIR": art}.items()))
    script = tmp_path / "runner.py"
    script.write_text(RUNNER)
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")}
    env.update(PYTHONPATH=str(REPO) + os.pathsep + env.get("PYTHONPATH", ""), OPTIM_SEED="1",
               VIS_ENCODER="tiny-test", DATASET_NAME="MNIST", DATASET_DIR=str(dataset),
               MODEL=model, SPLIT_SEED="500", CLIP_CKPT=ckpt, OMP_NUM_THREADS="1",
               **(env_overrides or {}))
    port = _free_port()
    procs = []
    for rank in range(n_procs):
        penv = dict(env)
        if n_procs > 1:
            penv.update(RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE=str(n_procs),
                        MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
        procs.append(subprocess.Popen(
            [sys.executable, str(script), str(yml), paradigm], env=penv, cwd=str(run_dir),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    return art, procs


def _finish(procs, expect_fail=False):
    """Wait for every process (each within TIMEOUT_S); returns their output."""
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=TIMEOUT_S)[0].decode(errors="replace"))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, out in zip(procs, outs):
        if expect_fail:
            assert p.returncode != 0, f"a rank should have failed:\n{out[-3000:]}"
        else:
            assert p.returncode == 0, f"a rank failed:\n{out[-4000:]}"
    return outs


def _runs(tmp_path, dataset, ckpt, model, paradigm, cfg, runs):
    """Start every (tag, n_procs, env) run of `runs` at once and wait for all;
    returns {tag: (artifact dir, outputs)}."""
    started = {tag: (_start(tmp_path, tag, n, dataset, ckpt, model, paradigm, cfg, env),
                     any(k.startswith("MNT_FAIL") for k in env or {}))
               for tag, n, env in runs}
    return {tag: (art, _finish(procs, expect_fail=fails))
            for tag, ((art, procs), fails) in started.items()}


def _listing(art):
    return sorted(str(p.relative_to(art)) for p in art.rglob("*")
                  if p.is_file() and "checkpoints" not in p.parts)


def _leaves(x):
    if isinstance(x, dict):
        return [v for k in sorted(x) for v in _leaves(x[k])]
    if isinstance(x, (list, tuple)):
        return [v for t in x for v in _leaves(t)]
    return [] if x is None else [np.asarray(x)]


def _results(art, model):
    lines = (art / f"results_model_{model}.json").read_text().splitlines()
    assert len(lines) == 1  # rank 0 alone appends
    rec = json.loads(lines[0])
    rec.pop("config")
    return rec


def _assert_same_run(single, group, model, exact):
    """Artifact names and result keys equal; pseudolabel pickles byte for
    byte; prompts and logits within 1e-4 and the same predictions (or every
    file byte for byte when `exact`, and the same results); the results'
    config (which names the artifact directory) aside."""
    assert _listing(group) == _listing(single) and _listing(single)
    rs, rg = _results(single, model), _results(group, model)
    assert sorted(rg) == sorted(rs)
    if exact:
        assert rg == rs
    for rel in _listing(single):
        if rel.startswith("results_model_"):
            continue
        a, b = (single / rel).read_bytes(), (group / rel).read_bytes()
        if exact or rel.startswith("pseudolabels"):
            assert a == b, rel
        elif rel.endswith(".pickle"):
            pa, pb = pickle.loads(a), pickle.loads(b)
            if isinstance(pa, dict) and "predictions" in pa:
                assert pa["predictions"] == pb["predictions"] and pa["images"] == pb["images"]
            la, lb = _leaves(pa), _leaves(pb)
            assert len(la) == len(lb) > 0
            for x, y in zip(la, lb):
                if np.issubdtype(x.dtype, np.floating):
                    np.testing.assert_allclose(y, x, rtol=1e-4, atol=1e-4, err_msg=rel)
                else:
                    np.testing.assert_array_equal(y, x, err_msg=rel)
    for k in rs:
        if k != "model":
            assert rg[k] == pytest.approx(rs[k], abs=1e-9), k


BASE_CFG = {"EPOCHS": 3, "BATCH_SIZE": 8, "N_LABEL": 2, "N_PSEUDOSHOTS": 2, "PREFIX_SIZE": 4}


@pytest.mark.parametrize("model, paradigm, cfg", [
    ("textual_fpl", "ssl", {}),
    ("visual_fpl", "ssl", {"EPOCHS": 2}),
    ("grip_textual", "ul", {"EPOCHS": 2, "STEP_QUANTILE": 50, "FUSED_BUCKETS": 2}),
    ("textual_fpl", "ssl", {"FUSED_TRAIN": False}),
], ids=["ssl-textual_fpl", "ssl-visual_fpl", "ul-grip_textual", "ssl-textual_fpl-per-step"])
def test_two_rank_run_matches_one_process(tmp_path, dataset, ckpt, model, paradigm, cfg):
    runs = _runs(tmp_path, dataset, ckpt, model, paradigm, {**BASE_CFG, **cfg},
                 [("single", 1, None), ("group", 2, None)])
    (single, _), (group, outs) = runs["single"], runs["group"]
    assert "process group: rank 0 of 2 (gloo) on cpu" in outs[0]
    trainer = "fused train:" if cfg.get("FUSED_TRAIN", True) else "epoch 0: loss="
    assert trainer in outs[0] and trainer not in outs[1]  # rank 0 logs
    _assert_same_run(single, group, model, exact=False)


@pytest.mark.parametrize("model, cfg, fail, resumed", [
    ("iterative_textual_fpl", {"EPOCHS": 2, "STEP_QUANTILE": 50}, "MNT_FAIL_AFTER_ITER",
     "resuming from checkpointed iteration 1"),
    ("textual_fpl", {"EPOCHS": 3, "FUSED_EPOCH_CHUNK": 1}, "MNT_FAIL_AFTER_CHUNK",
     "resuming fused training at epoch 1/3"),
], ids=["iteration", "chunk"])
def test_killed_group_resumes_as_an_uninterrupted_group(tmp_path, dataset, ckpt, model, cfg,
                                                        fail, resumed):
    """Kill the whole group after its first checkpoint, start it again in
    the same artifact directory: it resumes there (every rank at rank 0's
    point) and ends byte-identical to a group that was never killed."""
    cfg = {**BASE_CFG, **cfg}
    runs = _runs(tmp_path, dataset, ckpt, model, "ssl", cfg,
                 [("control", 2, None), ("crash", 2, {fail: "1"})])
    control, (crash, outs) = runs["control"][0], runs["crash"]
    assert any(f"fault injection: {fail}=1" in o for o in outs)
    assert any((crash / "checkpoints").rglob("iter_1" if "ITER" in fail else "chunk_*.pt"))
    again = _runs(tmp_path, dataset, ckpt, model, "ssl", cfg, [("crash", 2, None)])
    assert resumed in again["crash"][1][0]
    _assert_same_run(control, crash, model, exact=True)


# ------------------------------------------------- the step on rank blocks
def _ranks_in_threads(monkeypatch, world, fn):
    """Run fn(rank) for every rank in its own thread, with the all-reduce of
    `train_step` replaced by a sum of the ranks' buffers (in rank order, so
    every rank gets the same bits); returns the results by rank."""
    import threading

    from menghini_neurips23_tpu_torch.training import fused

    bar, bufs, local = threading.Barrier(world), {}, threading.local()

    def summed(x):
        bufs[local.rank] = x.clone()
        bar.wait(timeout=60)
        x.copy_(torch.stack([bufs[r] for r in range(world)]).sum(0))
        bar.wait(timeout=60)
        return x

    monkeypatch.setattr(fused.multihost, "all_reduce_sum_", summed)
    out, errors = {}, []

    def run(rank):
        local.rank = rank
        try:
            out[rank] = fn(rank)
        except BaseException as e:  # reported below, in the test's thread
            errors.append(e)
            bar.abort()

    threads = [threading.Thread(target=run, args=(r,)) for r in range(world)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not errors, errors
    assert not any(t.is_alive() for t in threads) and len(out) == world
    return out


def _linear_program(rank_world, seen_rows):
    """A FusedProgram over a linear prompt (logits = feats @ w^T) on 11
    training rows in batches of 8, both loss groups, one padded batch."""
    from menghini_neurips23_tpu_torch.training.fused import FusedProgram

    rng = np.random.default_rng(5)
    n, bs, C, E = 11, 8, 3, 6

    def logits_fn(tree, ctx, feats):
        seen_rows.append(feats.shape[0])
        return feats @ tree["w"].T + ctx

    prog = FusedProgram("cpu", logits_fn, logits_fn, steps=2, bs=bs, n_slot=n, epochs_padded=1,
                        trzsl=False, val_rows=None, accum=1, wd=0.01, momentum=0.9,
                        capture=False, rank_world=rank_world)
    perms = np.full((2, 2 * bs), -1, np.int64)
    perms[0, :n] = rng.permutation(n)
    host = {"perms": perms, "feats": rng.normal(0, 1, (n, E)).astype(np.float32),
            "labels": rng.integers(0, C, n).astype(np.int32),
            "groups": (np.arange(n) % 3 == 0).astype(np.int32),
            "lrs": np.asarray([0.5, 0.0], np.float32),
            "apply_flags": np.asarray([1.0, 1.0], np.float32),
            "w": np.asarray([0.7, 1.3], np.float32),
            "ctx_train": np.zeros(C, np.float32)}
    prog.memo_put({k: (k, v) for k, v in host.items()})
    w0 = {"w": rng.normal(0, 0.1, (C, E)).astype(np.float32)}
    zeros = {"w": np.zeros((C, E), np.float32)}
    prog.load_carry((w0, zeros, zeros, -np.inf, w0))
    return prog


@pytest.mark.parametrize("world", [2, 3])
def test_rank_blocks_with_a_summed_all_reduce_make_the_whole_batch_step(monkeypatch, world):
    """The whole-run trainer's step on every rank's block (3 rows of the
    8-row batch at world 3, the last block short and padded), with one
    summed all-reduce of the flat gradient, loss and count, equals the
    one-process step on the whole batch: the same prompt, momentum, loss
    and correct count on every rank (the padded second batch too)."""
    def steps(prog):
        for _ in range(2):
            prog.step()
        return ({k: v.detach().clone() for k, v in prog.prompt.items()},
                {k: v.clone() for k, v in prog.mom.items()}, prog.loss.clone(),
                prog.correct.clone())

    whole_rows = []
    want = steps(_linear_program(None, whole_rows))
    rows = {}

    def rank_run(rank):
        rows[rank] = []
        return steps(_linear_program((rank, world), rows[rank]))

    got = _ranks_in_threads(monkeypatch, world, rank_run)
    per = -(-8 // world)
    assert whole_rows == [8, 8] and all(rows[r] == [per, per] for r in range(world))
    for rank in range(world):
        (prompt, mom, loss, correct), (wp, wm, wl, wc) = got[rank], want
        torch.testing.assert_close(prompt["w"], wp["w"], rtol=1e-6, atol=1e-6)
        torch.testing.assert_close(mom["w"], wm["w"], rtol=1e-6, atol=1e-6)
        torch.testing.assert_close(loss, wl, rtol=1e-6, atol=1e-6)
        assert correct == wc
        assert torch.equal(prompt["w"], got[0][0]["w"])  # the ranks agree bit for bit


def test_one_rank_group_trains_bit_identical_to_no_group(tmp_path):
    """A gloo group of one rank takes the collective path (its block is the
    whole batch, its all-reduce a copy): the whole-run trainer's result is
    the one without a group bit for bit."""
    import torch.distributed as dist

    from menghini_neurips23_tpu_torch.parallel import multihost

    def run():
        rows = []
        prog = _linear_program(None if not dist.is_initialized() else (0, 1), rows)
        for _ in range(2):
            prog.step()
        return prog.prompt["w"].detach().clone(), prog.loss.clone()

    calls = multihost.all_reduce_sum_.calls
    without = run()
    assert multihost.all_reduce_sum_.calls == calls  # no group: no collective
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'store'}", rank=0,
                            world_size=1)
    try:
        multihost.warm_collectives()
        assert multihost.is_initialized() and multihost.process_count() == 1
        with_group = run()
    finally:
        dist.destroy_process_group()
    assert multihost.all_reduce_sum_.calls == calls + 2  # one a step
    assert torch.equal(with_group[0], without[0]) and torch.equal(with_group[1], without[1])
