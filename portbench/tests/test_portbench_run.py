"""The harness end to end on the CPU: the rehearsal path in a subprocess, the
refusals, and faults planted under the timed path, which `correct` has to catch."""

import contextlib
import io
import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

from portbench.harness.manifest import ROOT
from portbench.tests import fixtures

RUN = os.path.join(ROOT, "portbench", "run.py")
ENV = {k: v for k, v in os.environ.items() if k != "BENCH_RUN"}
ENV.update(CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="2")


@pytest.fixture(scope="module")
def manifest(tmp_path_factory):
    return fixtures.write_manifest(str(tmp_path_factory.mktemp("bench")))


def _args(manifest, cell, seed=3_000_000_019):
    return ["--workload", cell, "--seed", str(seed), "--seconds", "0.3", "--trace", "0",
            "--manifest", manifest, "--rehearse-cpu"]


@pytest.mark.parametrize("cell", sorted(fixtures.CELLS))
def test_rehearsal_in_a_subprocess_imports_no_jax(manifest, cell):
    probe = (
        "import json, runpy, sys; sys.argv = [sys.argv[1]] + sys.argv[2:];\n"
        "try:\n    runpy.run_path(sys.argv[0], run_name='__main__')\n"
        "except SystemExit as e:\n    code = e.code\n"
        "bad = sorted({m.split('.')[0] for m in sys.modules} & "
        "{'jax', 'jaxlib', 'flax', 'menghini_neurips23_tpu'})\n"
        "print(json.dumps({'exit': code, 'forbidden': bad}))\n")
    out = subprocess.run([sys.executable, "-c", probe, RUN, *_args(manifest, cell)],
                         capture_output=True, text=True, env=ENV, timeout=600, cwd=ROOT)
    lines = out.stdout.strip().splitlines()
    assert out.returncode == 0, out.stderr[-3000:]
    result, probe_line = json.loads(lines[-2]), json.loads(lines[-1])
    assert probe_line == {"exit": 0, "forbidden": []}
    assert result["correct"] is True
    assert "metrics" not in result and "device" not in result  # no CPU number as a device metric
    assert list(result)[-1] == "checks"
    assert result["attempted"] >= 1 and result["failed"] == 0


def test_no_card_no_result(manifest):
    out = subprocess.run([sys.executable, RUN, *_args(manifest, "tiny_pass")[:-1]],
                         capture_output=True, text=True, env=ENV, timeout=300, cwd=ROOT)
    assert out.returncode == 2 and out.stdout == ""
    assert "no CUDA device" in out.stderr


def test_only_the_benchmark_files_is_not_enough(tmp_path):
    shutil.copytree(os.path.join(ROOT, "portbench"), tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path / "BENCHMARK.json")
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", "vpt_l14_ul_fp32",
                          "--seed", "1", "--seconds", "1", "--trace", "0", "--rehearse-cpu"],
                         capture_output=True, text=True, env=dict(ENV, PYTHONPATH=""), timeout=300,
                         cwd=tmp_path)
    assert out.returncode != 0 and out.stdout == ""


def _run_in_process(manifest, cell):
    from portbench import run

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        code = run.main(_args(manifest, cell))
    assert code == 0
    return json.loads(buf.getvalue().strip().splitlines()[-1])


def _state_unchanged(monkeypatch):
    from menghini_neurips23_tpu_torch.training import fused

    real = fused.train_step

    def step(logits_fn, prompt, mom, gacc, *a, **kw):
        keep = {k: v.detach().clone() for k, v in prompt.items()}
        out = real(logits_fn, prompt, mom, gacc, *a, **kw)
        with torch.no_grad():
            for k, v in prompt.items():
                v.copy_(keep[k])
        return out

    monkeypatch.setattr(fused, "train_step", step)


def _half_batch(monkeypatch):
    from menghini_neurips23_tpu_torch.training import fused

    real = fused.two_group_loss

    def loss(logits, labels, group, valid, *a, **kw):
        half = torch.zeros_like(valid)
        half[: len(valid) // 2] = 1
        return real(logits, labels, group, valid * half, *a, **kw)

    monkeypatch.setattr(fused, "two_group_loss", loss)


def _validation_off(monkeypatch):
    """The epoch end's metric counts three validation rows too many."""
    from menghini_neurips23_tpu_torch.training import fused

    real = fused.masked_mean

    def metric(x, mask, *a, **kw):
        return real(x, mask, *a, **kw) + 3.0 / mask.numel()

    monkeypatch.setattr(fused, "masked_mean", metric)


def _best_never_taken(monkeypatch):
    """The epoch end's selection never keeps a prompt: the best stays the first."""
    from menghini_neurips23_tpu_torch.training import fused

    real = fused.FusedProgram.epoch_end

    def epoch_end(self):
        keep = {k: v.detach().clone() for k, v in self.best.items()}
        real(self)
        with torch.no_grad():
            for k, v in self.best.items():
                v.copy_(keep[k])

    monkeypatch.setattr(fused.FusedProgram, "epoch_end", epoch_end)


def _altered_probability(monkeypatch):
    from menghini_neurips23_tpu_torch.training import strategy

    real = strategy.fused_probs

    def probs(img, txt, scale):
        p = real(img, txt, scale).clone()
        p[:, 0] += 0.01  # every row's first class, a little
        return p

    monkeypatch.setattr(strategy, "fused_probs", probs)


def _altered_label(monkeypatch):
    from menghini_neurips23_tpu_torch.pseudo import engine

    real = engine.leaderboard_top_k

    def top_k(*a, **kw):
        paths, labels = real(*a, **kw)
        return paths, [labels[0] + 1] + list(labels[1:])

    monkeypatch.setattr(engine, "leaderboard_top_k", top_k)


@pytest.mark.parametrize("cell,fault,number", [
    ("tiny_coop", _state_unchanged, "change_gap"),
    ("tiny_vpt", _state_unchanged, "final_gap"),
    ("tiny_coop", _half_batch, "loss_gap"),
    ("tiny_vpt", _half_batch, "final_gap"),
    ("tiny_coop", _validation_off, "val_rows_off"),
    ("tiny_vpt", _validation_off, "val_rows_off"),
    ("tiny_coop", _best_never_taken, "best_gap"),
    ("tiny_vpt", _best_never_taken, "best_gap"),
    ("tiny_pass", _altered_probability, "prob_gap"),
    ("tiny_pass", _altered_label, "selection_diff"),
])
def test_a_planted_fault_is_not_correct(manifest, monkeypatch, cell, fault, number):
    fault(monkeypatch)
    result = _run_in_process(manifest, cell)
    assert result["correct"] is False
    check = result["checks"][number]
    assert not check["value"] <= check["limit"]


def test_the_sound_program_is_correct_in_process(manifest):
    assert _run_in_process(manifest, "tiny_coop")["correct"] is True


@pytest.mark.gpu
def test_a_cell_on_the_card():
    """On the card: one short traced run of the smallest cell."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run([sys.executable, RUN, "--workload", "coop_b32_ssl_fp32", "--seed", "5",
                          "--seconds", "3", "--trace", "1"], capture_output=True, text=True,
                         timeout=900, cwd=ROOT)
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert out.returncode == 0 and result["correct"] is True
    assert result["device"]["busy_s"] > 0 and "mfu.train" in result["metrics"]


CONTROL = os.path.join(ROOT, "portbench", "control.py")


def _control(args, env=ENV):
    out = subprocess.run([sys.executable, CONTROL, *args], capture_output=True, text=True,
                         env=env, timeout=900, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    return [json.loads(line) for line in out.stdout.strip().splitlines()]


def test_control_readings_on_the_cpu(manifest):
    """The control script's readings, by variant, for a training and a pass cell.
    (On the CPU there is no TF32: the control reads what fp32 reads.)"""
    train = _control(["--workload", "tiny_vpt", "--seeds", "4", "5", "--manifest", manifest,
                      "--rehearse-cpu", "--variants", "program", "control", "fault_half"])
    assert [r["seed"] for r in train] == [4, 5]
    for r in train:
        assert set(r["readings"]) == {"program", "control", "fault_half"}
        assert r["readings"]["fault_half"]["loss_gap"] > 1e-3
    only_ref = _control(["--workload", "tiny_coop", "--seeds", "6", "--manifest", manifest,
                         "--rehearse-cpu", "--variants", "control", "fault_half"])
    assert only_ref[0]["readings"]["fault_half"]["loss_gap"] > 1e-2
    passes = _control(["--workload", "tiny_pass", "--seeds", "7", "--manifest", manifest,
                       "--rehearse-cpu"])
    assert passes[0]["readings"]["program"]["selection_diff"] == 0


@pytest.mark.gpu
@pytest.mark.parametrize("cell", ["coop_b32_ssl_fp32", "fpl_l14_pass_fp32"])
def test_the_control_is_not_correct_on_the_card(cell):
    """The reference in TF32, put in the program's place at the cell's own
    size, fails at least one of the cell's limits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from portbench.harness import compare
    from portbench.harness.manifest import Bench

    limits = Bench(os.path.join(ROOT, "BENCHMARK.json")).workload(cell)["limits"]
    for r in _control(["--workload", cell, "--seeds", "11", "12", "13",
                       "--variants", "program", "control"], env=os.environ):
        assert compare.is_correct(compare.judge(r["readings"]["program"], limits))
        assert not compare.is_correct(compare.judge(r["readings"]["control"], limits))
