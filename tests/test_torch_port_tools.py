"""The port's tools against the JAX package's, on the CPU: the device top-k
(PSEUDO_TOPK='device'), the results aggregator and the environment doctor.

`device_topk` must be byte-identical to the exact leaderboard in every
regime: a pool above the 5M cells where it ranks on the device (here the
CPU) with no board overflowing, and the host delegations (a board overflow,
NaN confidences, a small pool, LABEL_ALL).  Each case holds the port's
output to the JAX package's `device_topk` and `leaderboard_top_k` on the
same numpy probabilities: lists equal, element for element.  The aggregator
must print the same Markdown, CSV, JSON and baseline comparison as the JAX
package's on the same results files.
"""

import json
import subprocess
import sys

import numpy as np
import pytest
import torch

from menghini_neurips23_tpu import aggregate as jax_aggregate
from menghini_neurips23_tpu.pseudo.device_topk import device_topk as jax_device_topk
from menghini_neurips23_tpu.pseudo.engine import LABEL_ALL, leaderboard_top_k
from menghini_neurips23_tpu_torch import aggregate, doctor
from menghini_neurips23_tpu_torch.pseudo import compute_pseudo_labels
from menghini_neurips23_tpu_torch.pseudo import device_topk as port_device_topk_mod
from menghini_neurips23_tpu_torch.pseudo.device_topk import _KERNEL_MIN_CELLS, device_topk
from tests.torch_port_fixtures import native_build_outside_checkout  # noqa: F401

torch.set_num_threads(2)

N_BIG, C_BIG = 50_000, 102  # 5.1M cells, above the device path's 5M


@pytest.fixture(scope="module")
def big_pool():
    rng = np.random.default_rng(11)
    logits = rng.normal(0, 2, (N_BIG, C_BIG))
    probs = np.exp(logits - logits.max(1, keepdims=True))
    probs /= probs.sum(1, keepdims=True)
    paths = [f"pool/img_{i:05d}.png" for i in range(N_BIG)]
    ids = [3 * j + 1 for j in range(C_BIG)]  # global ids that are not the columns
    return probs, paths, ids


def _all_three(probs, paths, k, ids):
    got = device_topk(probs, paths, k, ids, device="cpu")
    for want in (jax_device_topk(probs, paths, k, ids), leaderboard_top_k(probs, paths, k, ids)):
        assert got[0] == want[0] and got[1] == want[1]
    return got


def test_device_topk_ranks_a_large_pool_on_the_device(big_pool, monkeypatch):
    """No board overflows at k = 700 (the largest argmax count is below it):
    the masked torch.topk runs, and selects what the exact path selects."""
    probs, paths, ids = big_pool
    counts = np.bincount(probs.argmax(1), minlength=C_BIG)
    assert N_BIG * C_BIG >= _KERNEL_MIN_CELLS and counts.max() <= 700
    ranked = []
    inner = port_device_topk_mod._segmented_topk_scores
    monkeypatch.setattr(port_device_topk_mod, "_segmented_topk_scores",
                        lambda *a: ranked.append(a[-1]) or inner(*a))
    files, labels = _all_three(probs, paths, 700, ids)
    assert ranked == [torch.device("cpu")]
    assert len(files) == N_BIG and sorted(set(labels)) == ids


def test_device_topk_delegates_an_overflowing_pool(big_pool, monkeypatch):
    """k = 16 overflows every board: the exact host cascade, not the top-k."""
    probs, paths, ids = big_pool
    monkeypatch.setattr(port_device_topk_mod, "_segmented_topk_scores",
                        lambda *a: pytest.fail("ranked on the device"))
    files, labels = _all_three(probs, paths, 16, ids)
    assert len(files) == 16 * C_BIG


def test_device_topk_delegates_nan_confidences(big_pool, monkeypatch):
    probs, paths, ids = big_pool
    probs = probs.copy()
    probs[[7, 4000, 49_999], 5] = np.nan
    monkeypatch.setattr(port_device_topk_mod, "_segmented_topk_scores",
                        lambda *a: pytest.fail("ranked on the device"))
    _all_three(probs, paths, 700, ids)


@pytest.mark.parametrize("k", [3, 40, LABEL_ALL, 0], ids=["k3", "k40", "label-all", "k0"])
def test_device_topk_delegates_small_pools_and_label_all(k, monkeypatch):
    """Under 5M cells (overflowing at k = 3, not at 40), LABEL_ALL and k = 0
    take the host leaderboard."""
    rng = np.random.default_rng(12)
    probs = rng.dirichlet(np.ones(10), 200)
    paths = [f"p{i}.png" for i in range(200)]
    monkeypatch.setattr(port_device_topk_mod, "_segmented_topk_scores",
                        lambda *a: pytest.fail("ranked on the device"))
    _all_three(probs, paths, k, list(range(10)))


def test_compute_pseudo_labels_routes_device_to_device_topk(big_pool, tmp_path):
    """PSEUDO_TOPK='device' through the engine: the dataset takes the exact
    selection, and the pickle holds it."""
    from types import SimpleNamespace

    probs, paths, ids = big_pool
    classes = [str(i) for i in ids]
    ds = SimpleNamespace(filepaths=list(paths), labels=None, label_id=False)
    out = tmp_path / "pl.pickle"
    compute_pseudo_labels(probs, ds, classes, {c: i for c, i in zip(classes, ids)}, 700,
                          str(out), method="device", device=torch.device("cpu"))
    want = leaderboard_top_k(probs, paths, 700, ids)
    assert (ds.filepaths, ds.labels, ds.label_id) == (want[0], want[1], True)
    assert out.exists()


# ---------------------------------------------------------------- aggregate
def _results(tmp_path):
    def line(model, paradigm, dataset, seed, **metrics):
        return json.dumps({"model": model, "config": {
            "DATASET_NAME": dataset, "LEARNING_PARADIGM": paradigm, "MODEL": model,
            "VIS_ENCODER": "ViT-B/32", "SPLIT_SEED": 500, "OPTIM_SEED": seed}, **metrics})

    (tmp_path / "a").mkdir()
    (tmp_path / "a" / "results_model_grip_textual.json").write_text("\n".join(
        [line("grip_textual", "ssl", "MNIST", s, accuracy=a)
         for s, a in zip((1, 2, 3), (0.715, 0.722, 0.69))]
        + [line("grip_textual", "trzsl", "EuroSAT", 1, harmonic_mean=0.925,
                seen_accuracy=0.95, unseen_accuracy=0.9)]) + "\n")
    (tmp_path / "results_model_textual_fpl.json").write_text("\n".join(
        line("textual_fpl", "ul", "DTD", s, accuracy=a) for s, a in ((1, 0.5), (2, 0.52))) + "\n")
    return str(tmp_path)


@pytest.mark.parametrize("args", [[], ["--format", "csv"], ["--format", "json"],
                                  ["--baseline"], ["--baseline", "--format", "json"],
                                  ["--baseline", "--budget", "5"]],
                         ids=["md", "csv", "json", "baseline-md", "baseline-json", "budget"])
def test_aggregate_prints_what_the_jax_package_prints(tmp_path, capsys, args):
    root = _results(tmp_path)
    got_agg = aggregate.main([root, *args])
    got = capsys.readouterr()
    want_agg = jax_aggregate.main([root, *args])
    want = capsys.readouterr()
    assert got.out == want.out and got.err == want.err and got_agg == want_agg
    assert got.out.strip()


def test_aggregate_baseline_tables_are_the_jax_packages():
    assert aggregate.load_baseline_tables() == jax_aggregate.load_baseline_tables()


def test_aggregate_runs_as_a_module(tmp_path):
    root = _results(tmp_path)
    run = subprocess.run([sys.executable, "-m", "menghini_neurips23_tpu_torch.aggregate", root,
                          "--format", "csv"], capture_output=True, text=True, timeout=120)
    assert run.returncode == 0, run.stderr
    assert run.stdout == jax_aggregate.format_csv(
        jax_aggregate.aggregate(jax_aggregate.load_rows(jax_aggregate.collect_files([root])))
    ) + "\n"


# ------------------------------------------------------------------- doctor
def test_doctor_strict_fails_without_a_card_and_names_backend(tmp_path, capsys, monkeypatch):
    for var in ("CLIP_CKPT", "BPE_PATH", "CLIP_BPE_PATH"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("DATASET_DIR", str(tmp_path))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert doctor.main([]) == 0  # reports only
    out = capsys.readouterr().out
    assert out.startswith("[--] backend") and "no CUDA card" in out
    for name in ("clip weights", "tokenizer", "cuda kernels", "kernel build dir"):
        assert f"] {name}" in out
    assert "[ok] dataset dir" in out
    assert doctor.main(["--strict"]) == 1
    err = capsys.readouterr().err
    assert "strict: FAILED (backend, clip weights, tokenizer)" in err
