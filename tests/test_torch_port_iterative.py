"""The port's IFPL and GRIP iterations against the JAX package, on the CPU, at
the tiny-test width: the schedule and refresh helpers, whole iterative
workflows (every iteration's pseudolabels and prompt, the best metric, the
artifact listing and the checkpoint manifests), the checkpoint module, a
resumed run against an uninterrupted one, and the refresh's use of the best
prompt (the prompted-feature memos must miss after every prompt change).

The initial prompts are the JAX package's draws, carried across
(tests/test_torch_port_paradigms.py, tests/test_torch_port_multimodal.py).
Tolerances: prompts 1e-4 (rounding carried through the steps of several
iterations), the best metric 1e-6; pseudolabel sets, artifact names,
manifests (best metric aside) and the resumed run exact.
"""

import copy
import json
import logging
import os

import jax
import numpy as np
import pytest
import torch

from menghini_neurips23_tpu.checkpoint import run_key as jax_run_key
from menghini_neurips23_tpu.config import Config as JaxConfig
from menghini_neurips23_tpu.evaluation import persist as jax_persist
from menghini_neurips23_tpu.runners import common as jax_common
from menghini_neurips23_tpu.training.strategy import TrainingStrategy as JaxTrainingStrategy
from menghini_neurips23_tpu_torch import checkpoint
from menghini_neurips23_tpu_torch.config import Config
from menghini_neurips23_tpu_torch.evaluation import persist
from menghini_neurips23_tpu_torch.runners import common
from menghini_neurips23_tpu_torch.training import TrainingStrategy
from tests.test_torch_port_multimodal import _jax_upt_draws, _leaves_close
from tests.test_torch_port_paradigms import (  # noqa: F401
    RUNNERS,
    _jax_draws,
    _listing,
    _load,
    ckpt,
    runtimes,
)
from tests.torch_port_fixtures import native_build_outside_checkout  # noqa: F401

torch.set_num_threads(2)


# ---------------------------------------------------------------- helpers
@pytest.mark.parametrize("k", [1, 2, 5, 10])
@pytest.mark.parametrize("num_samples, n_unseen, pool", [
    (64, 10, 640),  # the paper's 10 iterations over a 640-image pool
    (155, 10, 620),  # SSL: the pool less the labeled shots
    (9, 3, 18),  # the tiny fixture
    (100, 3, 250),  # the pool cap: k * 100 / 3 outgrows the pool
    (1, 7, 5),  # a degenerate pool: at least one pseudoshot
])
def test_grip_pseudoshots_match_jax(k, num_samples, n_unseen, pool):
    got = TrainingStrategy._grip_pseudoshots(None, k, num_samples, n_unseen, pool)
    assert got == JaxTrainingStrategy._grip_pseudoshots(None, k, num_samples, n_unseen, pool)
    assert got >= 1 and (got * n_unseen <= pool or got == 1)


REFRESH_CASES = {
    # resolved paths are the pool's own: exact match, any order
    "exact": (["/d/train/a/x1.png", "/d/train/b/x2.png", "/d/train/a/x3.png"],
              ["/d/train/a/x3.png", "/d/train/a/x1.png"]),
    # layouts that rebuild the path string: the basename decides
    "basename": (["/d/train/a/x1.png", "/d/train/b/x2.png", "/d/train/a/x3.png"],
                 ["/d/val/b/x2.png", "/d/val/a/x1.png", "/d/val/a/x3.png"]),
    # a duplicated basename: exact matches keep the first pool row
    "duplicate-exact": (["/d/0/img0.png", "/d/1/img0.png"], ["/d/1/img0.png", "/d/0/img0.png"]),
    # a duplicated basename that only the basename could resolve: two-pass
    "duplicate-basename": (["/d/0/img0.png", "/d/1/img0.png"], ["/e/0/img0.png"]),
    # a name the pool does not hold: two-pass
    "unmatched": (["/d/0/img0.png"], ["/d/0/img9.png"]),
    "empty": ([], []),
}


@pytest.mark.parametrize("case", list(REFRESH_CASES))
def test_refresh_permutation_matches_jax(case):
    pool, resolved = REFRESH_CASES[case]
    got = TrainingStrategy._refresh_permutation(pool, resolved)
    want = JaxTrainingStrategy._refresh_permutation(pool, resolved)
    if want is None:
        assert got is None and case in ("duplicate-basename", "unmatched")
    else:
        assert got.dtype == np.int64 and got.tolist() == want.tolist()


def test_softmax64_matches_jax():
    logits = np.random.default_rng(0).normal(0, 30, (50, 7)).astype(np.float32)
    got = TrainingStrategy._softmax64(logits)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, JaxTrainingStrategy._softmax64(logits))


# ------------------------------------------------------------- checkpoint
def _ckpt_cfg(tmp_path, **kw):
    base = dict(DATASET_NAME="MNIST", LEARNING_PARADIGM="ssl", MODEL="grip_multimodal",
                VIS_ENCODER="ViT-B/32", OPTIM_SEED=3, SPLIT_SEED=500, ARTIFACT_DIR=str(tmp_path))
    base.update(kw)
    return base


def test_checkpoint_round_trip_and_layout(tmp_path):
    """The JAX package's run key and directory layout; a UPT parameter list
    (flax-layout dicts, a None deep slot, arrays) and the numpy RNG state
    come back exactly; a partial `.tmp` directory is ignored; clearing
    removes the run's checkpoints."""
    cfg = Config(**_ckpt_cfg(tmp_path))
    assert checkpoint.run_key(cfg) == jax_run_key(JaxConfig(**_ckpt_cfg(tmp_path)))
    rng = np.random.default_rng(0)
    params = [{"resblocks_0": {"ln_1": {"scale": rng.normal(size=4).astype(np.float32)}}},
              {"kernel": rng.normal(size=(3, 2)).astype(np.float32)}, None,
              rng.normal(size=(4, 8)).astype(np.float32)]
    gen = np.random.default_rng(9)
    gen.permutation(10)
    path = checkpoint.save_iteration_state(cfg, 2, 16, 0.75, params,
                                           rng_state=gen.bit_generator.state, reinit=3)
    assert path == os.path.join(str(tmp_path), "checkpoints", checkpoint.run_key(cfg), "iter_2")
    assert sorted(os.listdir(path)) == ["manifest.json", "params.pt"]
    os.makedirs(os.path.join(os.path.dirname(path), "iter_3.tmp"))  # an interrupted save
    state = checkpoint.latest_iteration_state(cfg)
    assert {k: state[k] for k in ("iteration", "n_pseudoshots", "best_metric", "run", "reinit")} \
        == {"iteration": 2, "n_pseudoshots": 16, "best_metric": 0.75,
            "run": checkpoint.run_key(cfg), "reinit": 3}
    restored = np.random.default_rng(0)
    restored.bit_generator.state = state["rng_state"]
    np.testing.assert_array_equal(restored.permutation(10), gen.permutation(10))
    _leaves_close(state["best_params"], params, 0)
    assert state["best_params"][2] is None
    with open(os.path.join(path, "manifest.json")) as f:
        assert set(json.load(f)) == {"iteration", "n_pseudoshots", "best_metric", "run",
                                     "rng_state", "reinit"}
    checkpoint.clear_run_checkpoints(cfg)
    assert checkpoint.latest_iteration_state(cfg) is None


def test_corrupt_checkpoint_warns_and_starts_fresh(tmp_path, caplog):
    cfg = Config(**_ckpt_cfg(tmp_path))
    path = checkpoint.save_iteration_state(cfg, 1, 4, 0.5, [np.zeros(2, np.float32)])
    with open(os.path.join(path, "params.pt"), "wb") as f:
        f.write(b"truncated")
    with caplog.at_level(logging.WARNING):
        assert checkpoint.latest_iteration_state(cfg) is None
    assert "could not restore checkpoint" in caplog.text


def test_save_pseudo_labels_names_match_jax(tmp_path):
    kw = dict(DATASET_NAME="MNIST", LEARNING_PARADIGM="trzsl", MODEL="grip_visual",
              VIS_ENCODER="ViT-B/32", OPTIM_SEED=2, SPLIT_SEED=7)
    persist.save_pseudo_labels(["a", "b"], [1, 0], Config(ARTIFACT_DIR=str(tmp_path / "port"), **kw),
                               iteration=3)
    jax_persist.save_pseudo_labels(["a", "b"], [1, 0],
                                   JaxConfig(ARTIFACT_DIR=str(tmp_path / "jax"), **kw), iteration=3)
    listing = _listing(tmp_path / "port")
    assert listing == _listing(tmp_path / "jax") == [
        "pseudolabels/MNIST_trzsl_grip_visual_ViT-B32_iter_3_opt_2_spl_7.pickle"]
    assert _load(tmp_path / "port" / listing[0]) == {"filepaths": ["a", "b"], "labels": [1, 0]}


# ---------------------------------------------------------------- workflows
def _kw(root, artifact_dir, ckpt, paradigm, model, **extra):
    kw = dict(
        DATASET_NAME="MNIST", DATASET_DIR=str(root.parent), MODEL=model, VIS_ENCODER="tiny-test",
        LEARNING_PARADIGM=paradigm, PROMPT_TEMPLATE="a photo of a {}", BATCH_SIZE=8, EPOCHS=2,
        PREFIX_SIZE=4, N_PSEUDOSHOTS=4, STEP_QUANTILE=50, LR=0.1, OPTIM_SEED=1, SPLIT_SEED=500,
        CLIP_CKPT=ckpt, TRANSFORMER_DIM=128, ARTIFACT_DIR=str(artifact_dir),
    )
    kw.update(extra)
    return kw


def _outside_checkpoints(root):
    return [f for f in _listing(root) if not f.startswith("checkpoints/")]


def _manifests(root):
    out = {}
    for rel in _listing(root):
        if rel.endswith("manifest.json"):
            with open(os.path.join(root, rel)) as f:
                out[os.path.dirname(rel)] = json.load(f)
    return out


def _spy_runs(monkeypatch, results):
    for mod, key in ((jax_common, "jax"), (common, "port")):
        def wrap(run, key=key):
            def wrapped(strategy, *a):
                results[key] = (strategy, run(strategy, *a))
                return results[key][1]
            return wrapped

        monkeypatch.setattr(mod, "run_strategy", wrap(mod.run_strategy))


ITERATIVE_CASES = [
    ("ssl", "grip_textual"),
    ("ul", "grip_visual"),
    ("trzsl", "iterative_visual_fpl"),
    ("ssl", "grip_multimodal"),
]


@pytest.mark.parametrize("paradigm, model", ITERATIVE_CASES,
                         ids=[f"{p}-{m}" for p, m in ITERATIVE_CASES])
def test_iterative_workflow_matches_jax(tmp_path, mnist_fixture, runtimes, ckpt, monkeypatch,
                                        paradigm, model):
    """STEP_QUANTILE 50: two iterations, the second refreshing its
    pseudolabels with the first's prompt."""
    root, _ = mnist_fixture
    jax_rt, port_rt = runtimes
    _jax_draws(monkeypatch)
    _jax_upt_draws(monkeypatch)
    results = {}
    _spy_runs(monkeypatch, results)
    jmod, pmod = RUNNERS[paradigm]
    jcfg = JaxConfig(**_kw(root, tmp_path / "jax", ckpt, paradigm, model))
    pcfg = Config(**_kw(root, tmp_path / "port", ckpt, paradigm, model))
    jresp = jmod.workflow(jcfg.DATASET_DIR, jcfg, runtime=jax_rt)
    presp = pmod.workflow(pcfg.DATASET_DIR, pcfg, runtime=port_rt)

    _, (jbest, jparams) = results["jax"]
    _, (pbest, pparams) = results["port"]
    assert pbest == pytest.approx(jbest, abs=1e-6)
    _leaves_close(pparams, jax.tree.map(np.asarray, jparams), 1e-4)
    listing = _outside_checkpoints(tmp_path / "port")
    assert listing == _outside_checkpoints(tmp_path / "jax")
    assert pcfg.N_PSEUDOSHOTS == jcfg.N_PSEUDOSHOTS  # the schedule left on the shared config
    iters = sorted(f for f in listing if f.startswith("pseudolabels/") and "_iter_" in f)
    assert len(iters) == 2
    for rel in iters:  # the same pseudolabel set in every iteration
        assert _load(tmp_path / "port" / rel) == _load(tmp_path / "jax" / rel)
    for it in (1, 2):  # every iteration's prompt
        _leaves_close(persist.load_saved_parameters(pcfg, it),
                      jax.tree.map(np.asarray, jax_persist.load_saved_parameters(jcfg, it)), 1e-4)
    pman, jman = _manifests(tmp_path / "port"), _manifests(tmp_path / "jax")
    assert sorted(pman) == sorted(jman) and len(pman) == 2
    for key in pman:
        assert pman[key].keys() == jman[key].keys()
        assert pman[key]["best_metric"] == pytest.approx(jman[key]["best_metric"], abs=1e-6)
        for field in ("iteration", "n_pseudoshots", "run", "rng_state", "reinit"):
            assert pman[key][field] == jman[key][field], field
    np.testing.assert_allclose(np.asarray(presp, float), np.asarray(jresp, float),
                               rtol=0, atol=0, equal_nan=True)


@pytest.mark.parametrize("paradigm, model", [("ssl", "grip_textual"), ("ssl", "grip_multimodal")])
def test_resumed_run_is_bit_identical(tmp_path, mnist_fixture, runtimes, ckpt, monkeypatch,
                                      paradigm, model):
    """MNT_FAIL_AFTER_ITER=1 stops a run after its first iteration; RESUME
    then runs the second: the same prompts, pseudolabels, best metric and
    numpy RNG state as one uninterrupted run, bit for bit."""
    root, _ = mnist_fixture
    _, port_rt = runtimes
    runner = RUNNERS[paradigm][1]
    results = {}

    def spy(strategy, *a, run=common.run_strategy):
        results.setdefault("runs", []).append(run(strategy, *a))
        results["strategy"] = strategy
        return results["runs"][-1]

    monkeypatch.setattr(common, "run_strategy", spy)
    whole = Config(**_kw(root, tmp_path / "whole", ckpt, paradigm, model))
    runner.workflow(whole.DATASET_DIR, whole, runtime=port_rt)
    whole_state = results["strategy"]._rng.bit_generator.state
    monkeypatch.setenv("MNT_FAIL_AFTER_ITER", "1")
    cut = Config(**_kw(root, tmp_path / "cut", ckpt, paradigm, model))
    with pytest.raises(RuntimeError, match="fault injection: MNT_FAIL_AFTER_ITER=1"):
        runner.workflow(cut.DATASET_DIR, cut, runtime=port_rt)
    assert [m["iteration"] for m in _manifests(tmp_path / "cut").values()] == [1]
    monkeypatch.delenv("MNT_FAIL_AFTER_ITER")
    resumed = Config(**_kw(root, tmp_path / "cut", ckpt, paradigm, model))
    runner.workflow(resumed.DATASET_DIR, resumed, runtime=port_rt)
    (wbest, wparams), (rbest, rparams) = results["runs"][0], results["runs"][-1]
    assert rbest == wbest
    _leaves_close(rparams, wparams, 0)
    assert results["strategy"]._rng.bit_generator.state == whole_state
    assert _listing(tmp_path / "cut") == _listing(tmp_path / "whole")
    for rel in _listing(tmp_path / "whole"):
        if rel.startswith("pseudolabels/") or rel.endswith("manifest.json"):
            assert _load_any(tmp_path / "cut" / rel) == _load_any(tmp_path / "whole" / rel), rel
    for it in (1, 2):
        _leaves_close(persist.load_saved_parameters(resumed, it),
                      persist.load_saved_parameters(whole, it), 0)
    # a finished run resumes to its stored result without training
    results["runs"].clear()
    again = Config(**_kw(root, tmp_path / "cut", ckpt, paradigm, model))
    monkeypatch.setattr(TrainingStrategy, "train", lambda *a, **k: pytest.fail("trained again"))
    runner.workflow(again.DATASET_DIR, again, runtime=port_rt)
    assert results["runs"][0][0] == wbest
    _leaves_close(results["runs"][0][1], wparams, 0)


def _load_any(path):
    if str(path).endswith(".json"):
        with open(path) as f:
            return json.load(f)
    return _load(path)


@pytest.mark.parametrize("model", ["grip_visual", "grip_multimodal"])
def test_refresh_scores_the_pool_with_the_best_prompt(tmp_path, mnist_fixture, runtimes, ckpt,
                                                      monkeypatch, model):
    """Three iterations.  Each refresh (iterations 2 and 3) must score the
    pool with the best prompt so far - reloaded after that iteration's
    training - not with a memo of prompted features (VPT) or logits (UPT)
    from an earlier prompt: its pseudolabels equal those a fresh strategy
    computes from the checkpointed best prompt with no memo."""
    root, _ = mnist_fixture
    _, port_rt = runtimes
    refreshes = []
    real = TrainingStrategy.get_pseudo_labels

    def recorded(self, pool):
        before = copy.deepcopy(pool)
        out = real(self, pool)
        refreshes.append((self.config.N_PSEUDOSHOTS, before, list(out.filepaths),
                          list(out.labels)))
        return out

    monkeypatch.setattr(TrainingStrategy, "get_pseudo_labels", recorded)
    seen = {}

    def spy(strategy, *a, run=common.run_strategy):
        seen["s"] = strategy
        return run(strategy, *a)

    monkeypatch.setattr(common, "run_strategy", spy)
    cfg = Config(**_kw(root, tmp_path, ckpt, "ul", model, STEP_QUANTILE=33))
    main_ul = RUNNERS["ul"][1]
    main_ul.workflow(cfg.DATASET_DIR, cfg, runtime=port_rt)
    assert len(refreshes) == 2
    strat = seen["s"]
    for it, (k, pool, files, labels) in zip((1, 2), refreshes):
        best = torch.load(os.path.join(tmp_path, "checkpoints", checkpoint.run_key(cfg),
                                       f"iter_{it}", "params.pt"), weights_only=True)
        fresh = type(strat)(cfg, strat.label_to_idx, strat.classes, strat.seen_classes,
                            strat.unseen_classes, runtime=port_rt, data_folder=strat.data_folder)
        fresh.load_parameters(checkpoint._to_numpy(best))
        fresh.config.N_PSEUDOSHOTS = k
        want = real(fresh, pool)
        assert (files, labels) == (list(want.filepaths), list(want.labels)), it


@pytest.mark.parametrize("model, iteration", [("grip_multimodal", 1), ("grip_visual", None)])
def test_predict_with_trained_prompts_matches_jax(tmp_path, mnist_fixture, runtimes, ckpt,
                                                  monkeypatch, model, iteration):
    """predict with a trained MODEL loads its saved prompt (an IFPL/GRIP
    iteration's with --iteration) and classifies with it: the same classes
    and confidences as the JAX package's predict on the same artifacts."""
    from menghini_neurips23_tpu import predict as jax_predict
    from menghini_neurips23_tpu_torch import predict

    root, _ = mnist_fixture
    _, port_rt = runtimes
    monkeypatch.chdir(tmp_path)
    cfg = Config(**_kw(root, tmp_path / "artifacts", ckpt, "ssl", model))
    RUNNERS["ssl"][1].workflow(cfg.DATASET_DIR, cfg, runtime=port_rt)
    yml = tmp_path / "pred.yml"
    yml.write_text(f"CLIP_CKPT: {ckpt}\nARTIFACT_DIR: {tmp_path / 'artifacts'}\n"
                   "PREFIX_SIZE: 4\nTRANSFORMER_DIM: 128\nBATCH_SIZE: 8\n")
    env = dict(OPTIM_SEED="1", SPLIT_SEED="500", VIS_ENCODER="tiny-test", DATASET_NAME="MNIST",
               DATASET_DIR=str(root.parent), MODEL=model)
    argv = ["--model_config", str(yml), "--learning_paradigm", "ssl", "--images",
            str(root / "test"), "--top_k", "2"]
    if iteration is not None:
        argv += ["--iteration", str(iteration)]
    want = jax_predict.main(argv + ["--output", str(tmp_path / "jax.json")], env=env)
    got = predict.main(argv + ["--output", str(tmp_path / "port.json")], env=env, device="cpu")
    assert len(got) == len(want) == 18
    assert [p["image"] for p in got] == [p["image"] for p in want]
    assert [[t["class"] for t in p["top_k"]] for p in got] == [
        [t["class"] for t in p["top_k"]] for p in want]
    np.testing.assert_allclose([t["confidence"] for p in got for t in p["top_k"]],
                               [t["confidence"] for p in want for t in p["top_k"]],
                               rtol=0, atol=1e-5)
    assert json.loads((tmp_path / "port.json").read_text())["model"] == model
