"""The port's whole-run trainer (`FUSED_TRAIN`, training/fused.py) on the
CPU, at the tiny-test width.  Here its step and epoch-end functions run
eagerly - the plain version of the CUDA graphs the card replays, which
tests/test_torch_port_gpu.py holds against it.

- Against the port's own per-step loop (`FUSED_TRAIN=False`), for CoOp, VPT
  shallow and deep, and UPT, from the same prompt and RNG state: best
  accuracy within abs 1e-6, prompts within rtol 2e-4 / atol 1e-6, UPT 5e-4:
  the JAX package's tolerances for its own fused-vs-loop tests
  (tests/test_fused_train.py).  The two forms validate differently (device
  logits vs host NumPy logits), which only a near-tie argmax could tell
  apart; the fixture's validation logits are checked free of them.
- Against the JAX package's fused trainer on whole main_ssl and main_trzsl
  textual_fpl workflows, from the JAX package's initial prompt: the same
  best accuracy (abs 1e-6: both are fp32 metrics), prompts within 1e-4 (the
  port's workflow tests' tolerance: rounding carried through several steps).
- TRZSL's harmonic mean, ACCUMULATION_ITER=2, FUSED_EPOCH_CHUNK, the GRIP
  shape ladder, FUSED_REMAT: each must leave the result as it was - bit for
  bit, since each only pads or splits the same arithmetic.
- A run killed by MNT_FAIL_AFTER_CHUNK and resumed equals an uninterrupted
  one bit for bit; repeated runs upload only what changed; the fallback
  reasons take the per-step loop.
"""

import copy
import glob
import logging
import re

import jax
import numpy as np
import pytest
import scipy.stats as st
import torch

from menghini_neurips23_tpu.config import Config as JaxConfig
from menghini_neurips23_tpu.data import dataset_object as jax_dataset_object
from menghini_neurips23_tpu.models import TINY_TEST as JAX_TINY
from menghini_neurips23_tpu.models.prompts import init_prefix as jax_init_prefix
from menghini_neurips23_tpu.runners import common as jax_common
from menghini_neurips23_tpu.runners import main_ssl as jax_main_ssl
from menghini_neurips23_tpu.runners import main_trzsl as jax_main_trzsl
from menghini_neurips23_tpu.runtime import ClipRuntime as JaxClipRuntime
from menghini_neurips23_tpu.training import TextualStrategy as JaxTextualStrategy
from menghini_neurips23_tpu_torch.checkpoint import latest_iteration_state
from menghini_neurips23_tpu_torch.config import Config
from menghini_neurips23_tpu_torch.data import dataset_object
from menghini_neurips23_tpu_torch.runners import common, main_ssl, main_trzsl
from menghini_neurips23_tpu_torch.runtime import ClipRuntime
from menghini_neurips23_tpu_torch.training import (
    MultimodalStrategy,
    TextualStrategy,
    TrainingStrategy,
    VisualStrategy,
)
from menghini_neurips23_tpu_torch.training import textual as port_textual
from menghini_neurips23_tpu_torch.training.strategy import EpochData
from tests.conftest import make_mnist_fixture
from tests.test_torch_parity import _make_state_dict
from tests.torch_port_fixtures import native_build_outside_checkout  # noqa: F401

torch.set_num_threads(2)

CLASSES = ["0", "1", "2"]
N_TRAIN, N_VAL, N_PER_CLASS = 7, 3, 12  # per class: 21 training rows = 3 batches of 8

STRATEGIES = {
    "coop": (TextualStrategy, dict(MODEL="textual_prompt", MODALITY="text")),
    "vpt": (VisualStrategy, dict(MODEL="visual_prompt", MODALITY="image")),
    "vpt_deep": (VisualStrategy, dict(MODEL="visual_prompt", MODALITY="image", VPT_DEEP=True)),
    "upt": (MultimodalStrategy, dict(MODEL="multimodal_prompt", MODALITY="multi")),
}


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    # seed 16, as the port's other workflow tests: free of near-ties there
    sd = _make_state_dict(JAX_TINY, np.random.default_rng(16))
    path = tmp_path_factory.mktemp("ckpt") / "tiny_openai.pt"
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, path)
    return str(path)


@pytest.fixture(scope="module")
def port_rt(ckpt):
    return ClipRuntime(Config(VIS_ENCODER="tiny-test", BATCH_SIZE=8, CLIP_CKPT=ckpt), device="cpu")


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("fused_data") / "MNIST"
    make_mnist_fixture(root, n_per_class=N_PER_CLASS)
    return root


def _cfg(tmp_path, ckpt, **kw):
    base = dict(
        DATASET_NAME="MNIST", VIS_ENCODER="tiny-test", LEARNING_PARADIGM="ssl",
        PROMPT_TEMPLATE="a photo of a {}", BATCH_SIZE=8, EPOCHS=3, PREFIX_SIZE=4,
        TEXT_PREFIX_SIZE=2, VISION_PREFIX_SIZE=2, TRANSFORMER_DIM=16, N_PSEUDOSHOTS=2,
        N_LABEL=2, OPTIM_SEED=1, SPLIT_SEED=500, LR=0.1, CLIP_CKPT=ckpt,
        ARTIFACT_DIR=str(tmp_path), MODEL="textual_prompt", MODALITY="text",
    )
    base.update(kw)
    return Config(**base)


def _datasets(root, n_train=N_TRAIN, n_val=N_VAL, dataset=dataset_object):
    """(label_to_idx, train, val, unlabeled pool) from the train split, as
    the dataset objects of `dataset` (the port's, or the JAX package's)."""
    l2i = {c: i for i, c in enumerate(CLASSES)}
    DS = dataset("MNIST")

    def files(lo, hi):
        return [f"train/{c}/{c}_img{i}.png" for c in CLASSES for i in range(lo, hi)]

    def labels(lo, hi):
        return [c for c in CLASSES for _ in range(lo, hi)]

    train = DS(files(0, n_train), str(root), train=True, labels=labels(0, n_train),
               label_map=l2i)
    val = DS(files(n_train, n_train + n_val), str(root), train=True,
             labels=labels(n_train, n_train + n_val), label_map=l2i)
    pool = DS(files(n_train + n_val, N_PER_CLASS), str(root), train=True, labels=None,
              label_map=l2i)
    return l2i, train, val, pool


def _strategy(cls, cfg, rt, root, pool=None, seen=CLASSES, unseen=CLASSES):
    l2i = {c: i for i, c in enumerate(CLASSES)}
    return cls(cfg, l2i, CLASSES, list(seen), list(unseen), data_folder=str(root),
               unlabeled_files=[f.split("/")[-1] for f in pool.filepaths] if pool else None,
               runtime=rt)


def _leaves(tree):
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in _leaves(t)]
    return [np.asarray(tree)]


def _close(a, b, rtol, atol):
    la, lb = _leaves(a), _leaves(b)
    assert len(la) == len(lb) > 0
    for x, y in zip(la, lb):
        np.testing.assert_allclose(x, y, rtol=rtol, atol=atol)


def _equal(a, b):
    _close(a, b, 0, 0)


def _train(name, tmp_path, ckpt, rt, root, **kw):
    cls, model = STRATEGIES[name]
    cfg = _cfg(tmp_path, ckpt, **{**model, **kw})
    _, train, val, _ = _datasets(root)
    strat = _strategy(cls, cfg, rt, root)
    acc, params = strat.train(train, val, only_seen=True)
    return strat, acc, params


def _val_margin(strat, root):
    """The smallest top-2 gap of the validation logits under the strategy's
    current prompt (host NumPy, the per-step loop's computation)."""
    _, _, val, _ = _datasets(root)
    logits = strat._predict_logits(val.filepaths, CLASSES)
    top2 = np.sort(logits, axis=1)[:, -2:]
    return float((top2[:, 1] - top2[:, 0]).min())


# --------------------------------------------------- fused vs per-step loop
@pytest.mark.parametrize("name", list(STRATEGIES))
def test_fused_equals_per_step_loop(tmp_path, ckpt, port_rt, data_root, name):
    runs = {}
    for fused in (True, False):
        runs[fused] = _train(name, tmp_path / str(fused), ckpt, port_rt, data_root,
                             FUSED_TRAIN=fused)
    (sf, acc_f, pf), (sl, acc_l, pl) = runs[True], runs[False]
    assert sf._fused_info["epochs"] == 3 and sf._fused_info["steps_per_epoch"] == 3
    assert sf._fused_info["graphs"] is False  # the CPU runs the functions eagerly
    assert not hasattr(sl, "_fused_info")
    margin = _val_margin(sl, data_root)
    assert margin > 1e-4, f"near-tie in the validation logits: margin {margin}"
    assert acc_f == pytest.approx(acc_l, abs=1e-6)
    rtol = 5e-4 if name == "upt" else 2e-4
    _close(pf, pl, rtol, 1e-6)  # the best epoch's prompt
    _close(sf.epoch_parameters(), sl.epoch_parameters(), rtol, 1e-6)  # the final one
    _, _, start = _train(name, tmp_path / "start", ckpt, port_rt, data_root, EPOCHS=1, LR=0.0)
    assert not np.array_equal(_leaves(sf.epoch_parameters())[-1], _leaves(start)[-1])


def test_fused_logs_its_run_and_keeps_the_final_prompt(tmp_path, ckpt, port_rt, data_root,
                                                       caplog):
    with caplog.at_level(logging.INFO, logger="menghini_neurips23_tpu_torch.training.strategy"):
        strat, acc, params = _train("coop", tmp_path, ckpt, port_rt, data_root, EPOCHS=4)
    lines = [r.getMessage() for r in caplog.records]
    summary = [m for m in lines if m.startswith("fused train: 4 epochs, best epoch")]
    assert len(summary) == 1 and sum(m.startswith("epoch ") for m in lines) == 4
    best = int(summary[0].split("best epoch ")[1].split()[0])
    assert f"val={acc:.4f}" in summary[0]
    # the strategy keeps the final epoch's prompt; the best epoch's is returned
    assert (best == 3) == np.array_equal(strat.epoch_parameters()[0], params[0])
    assert strat._fused_cache == {}  # train() frees its program at its end


# ------------------------------------------------------------ vs the JAX one
def _jax_prefix_draw(monkeypatch):
    monkeypatch.setattr(
        port_textual, "init_prefix",
        lambda gen, length, dim, init, mean, std: torch.from_numpy(np.array(
            jax_init_prefix(jax.random.PRNGKey(gen.initial_seed()), length, dim, init, mean,
                            std))),
    )


@pytest.mark.parametrize("paradigm", ["ssl", "trzsl"])
def test_fused_workflow_matches_jax_fused(tmp_path, mnist_fixture, ckpt, port_rt, monkeypatch,
                                         paradigm):
    """Whole textual_fpl workflows; both packages take their fused trainer
    (FUSED_TRAIN defaults to True in both)."""
    root, _ = mnist_fixture
    jax_rt = JaxClipRuntime(JaxConfig(VIS_ENCODER="tiny-test", BATCH_SIZE=8, CLIP_CKPT=ckpt))
    _jax_prefix_draw(monkeypatch)
    results = {}

    def spy(mod, key):
        run = mod.run_strategy

        def wrapped(strategy, *a):
            results[key] = (strategy, run(strategy, *a))
            return results[key][1]

        monkeypatch.setattr(mod, "run_strategy", wrapped)

    spy(jax_common, "jax")
    spy(common, "port")
    kw = dict(DATASET_NAME="MNIST", DATASET_DIR=str(root.parent), MODEL="textual_fpl",
              VIS_ENCODER="tiny-test", LEARNING_PARADIGM=paradigm,
              PROMPT_TEMPLATE="a photo of a {}", BATCH_SIZE=8, EPOCHS=3, PREFIX_SIZE=4,
              N_PSEUDOSHOTS=16, LR=0.1, OPTIM_SEED=1, SPLIT_SEED=500, CLIP_CKPT=ckpt)
    jcfg = JaxConfig(**kw, ARTIFACT_DIR=str(tmp_path / "jax"))
    pcfg = Config(**kw, ARTIFACT_DIR=str(tmp_path / "port"))
    jmod, pmod = {"ssl": (jax_main_ssl, main_ssl), "trzsl": (jax_main_trzsl, main_trzsl)}[paradigm]
    jmod.workflow(jcfg.DATASET_DIR, jcfg, runtime=jax_rt)
    pmod.workflow(pcfg.DATASET_DIR, pcfg, runtime=port_rt)
    jstrat, (jbest, jparams) = results["jax"]
    pstrat, (pbest, pparams) = results["port"]
    assert pstrat._fused_info["epochs"] == 3 and pstrat.val_unseen_files is not None
    assert pbest == pytest.approx(jbest, abs=1e-6)
    np.testing.assert_allclose(pparams[0], np.asarray(jparams[0]), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(pstrat.epoch_parameters()[0], np.asarray(jstrat.prefix),
                               rtol=1e-4, atol=1e-4)


# ------------------------------------------------------------------- metrics
def test_trzsl_metric_is_the_seen_unseen_harmonic_mean(tmp_path, ckpt, port_rt, data_root):
    """One epoch at lr 0 validates the drawn prompt: the fused metric is the
    per-step loop's scipy harmonic mean of the seen and unseen accuracies
    over the pseudo-val-augmented set."""
    cfg = _cfg(tmp_path, ckpt, MODEL="textual_fpl", LEARNING_PARADIGM="trzsl", EPOCHS=1, LR=0.0,
               N_PSEUDOSHOTS=10)
    l2i, train, val, pool = _datasets(data_root)
    seen, unseen = CLASSES[:1], CLASSES[1:]
    keep = [i for i, l in enumerate(train.labels) if l in seen]
    train.filepaths = [train.filepaths[i] for i in keep]
    train.labels = [train.labels[i] for i in keep]
    vkeep = [i for i, l in enumerate(val.labels) if l in seen]
    val.filepaths = [val.filepaths[i] for i in vkeep]
    val.labels = [val.labels[i] for i in vkeep]
    strat = _strategy(TextualStrategy, cfg, port_rt, data_root, pool, seen, unseen)
    acc, _ = strat.train(train, val, pool, only_seen=False)
    assert strat.val_unseen_files is not None
    want = strat._run_validation(strat._prepare_val_data(val))
    labels = strat._prepare_val_data(val)[1]
    assert (labels == 0).any() and (labels != 0).any()  # both halves present
    assert acc == pytest.approx(want, abs=1e-6)
    logits = strat._predict_logits(*strat._prepare_val_data(val)[::2])
    pred = logits.argmax(1)
    parts = [(pred[m] == labels[m]).mean() for m in (labels == 0, labels != 0)]
    assert want == (st.hmean(parts) if min(parts) > 0 else 0.0)


def test_accumulation_applies_every_second_and_the_last_batch(tmp_path, ckpt, port_rt,
                                                              data_root):
    """ACCUMULATION_ITER=2 over 3 batches: the update applies after batch 2
    and after the last one, in both forms."""
    strat = _strategy(TextualStrategy, _cfg(tmp_path, ckpt), port_rt, data_root)
    _, train, val, _ = _datasets(data_root)
    epoch = strat._prepare_epoch_data(train, CLASSES, True)
    strat.config.ACCUMULATION_ITER = 2
    np.testing.assert_array_equal(
        strat._fused_train_inputs(epoch, strat._prepare_val_data(val))["apply_flags"], [0, 1, 1])
    runs = {fused: _train("coop", tmp_path / str(fused), ckpt, port_rt, data_root,
                          FUSED_TRAIN=fused, ACCUMULATION_ITER=2, MOMENTUM=0.9)
            for fused in (True, False)}
    assert runs[True][1] == pytest.approx(runs[False][1], abs=1e-6)
    _close(runs[True][2], runs[False][2], 2e-4, 1e-6)
    _close(runs[True][0].epoch_parameters(), runs[False][0].epoch_parameters(), 2e-4, 1e-6)
    # accumulating is not applying every batch
    every = _train("coop", tmp_path / "every", ckpt, port_rt, data_root, MOMENTUM=0.9)
    assert not np.allclose(every[0].epoch_parameters()[0], runs[True][0].epoch_parameters()[0])


@pytest.mark.parametrize("chunk", [2, 3])
def test_epoch_chunks_change_nothing(tmp_path, ckpt, port_rt, data_root, chunk):
    """FUSED_EPOCH_CHUNK 2 and 3 over 5 epochs (one padded epoch each) give
    chunk 0's run: the same stats, best and final prompts, bit for bit."""
    runs = {}
    for c in (0, chunk):
        strat, acc, params = _train("coop", tmp_path / f"c{c}", ckpt, port_rt, data_root,
                                    EPOCHS=5, FUSED_EPOCH_CHUNK=c, MOMENTUM=0.9,
                                    CHECKPOINT_ITER=False)
        runs[c] = (acc, params, strat.epoch_parameters())
    assert runs[0][0] == runs[chunk][0]
    _equal(runs[0][1], runs[chunk][1])
    _equal(runs[0][2], runs[chunk][2])


def test_remat_changes_nothing(tmp_path, ckpt, port_rt, data_root):
    runs = {r: _train("vpt_deep", tmp_path / str(r), ckpt, port_rt, data_root, FUSED_REMAT=r)
            for r in (False, True)}
    assert runs[False][1] == runs[True][1]
    _equal(runs[False][2], runs[True][2])


# ------------------------------------------------------ GRIP ladder, resume
def _grip(tmp_path, ckpt, rt, root, **kw):
    cfg = _cfg(tmp_path, ckpt, MODEL="grip_textual", STEP_QUANTILE=50, EPOCHS=2,
               RESUME=False, CHECKPOINT_ITER=False, **kw)
    # 2 labeled rows per class, a pool of 9 per class: the training set grows
    # from 17 rows to 30 over the two iterations
    _, train, val, pool = _datasets(root, n_train=2, n_val=1)
    strat = _strategy(TextualStrategy, cfg, rt, root, pool)
    return strat, strat.grip_train(train, val, pool)


def test_grip_bucket_ladder_changes_nothing(tmp_path, ckpt, port_rt, data_root):
    """FUSED_BUCKETS 0 (exact shapes), 1 (one full-pool shape) and 3 give the
    same GRIP run; 1 builds one program over both iterations (on the card:
    one capture), 3 two (rungs of 11, 22 and 33 rows), 0 one per size."""
    runs, builds = {}, {}
    for nb in (0, 1, 3):
        strat, (acc, params) = _grip(tmp_path / f"nb{nb}", ckpt, port_rt, data_root,
                                     FUSED_BUCKETS=nb)
        runs[nb], builds[nb] = (acc, params), strat._fused_builds
        assert strat._fused_bucket is None and strat._fused_cache == {}  # cleared after
    for nb in (1, 3):
        assert runs[nb][0] == runs[0][0]
        _equal(runs[nb][1], runs[0][1])
    assert (builds[0], builds[1], builds[3]) == (2, 1, 2)


def _logged_final_losses(caplog, logger):
    return [float(m) for r in caplog.records if r.name == logger
            for m in re.findall(r"^fused train: .* loss=(\S+)\)$", r.getMessage())]


def test_fused_logs_the_jax_fused_trainers_loss_on_a_padded_rung(tmp_path, ckpt, port_rt,
                                                                  data_root, monkeypatch, caplog):
    """GRIP with FUSED_BUCKETS=3 (rungs of 11, 22 and 33 rows) in both
    packages' whole-run trainers, from the JAX package's initial prompts:
    iteration 1's 17 rows take the 22-row rung, 3 batches of 8 as its real
    3; iteration 2's 14 (the refresh keeps fewer pseudolabels) take it too,
    3 slot batches against 2 real ones, so the JAX scan's last step is an
    all-padding batch and logs loss=0.0000.  The port's `fused train:` lines log the same numbers
    (within a unit of the printed 4th decimal: the prompts agree to 1e-4)."""
    _jax_prefix_draw(monkeypatch)
    jax_rt = JaxClipRuntime(JaxConfig(VIS_ENCODER="tiny-test", BATCH_SIZE=8, CLIP_CKPT=ckpt))
    kw = dict(MODEL="grip_textual", STEP_QUANTILE=50, EPOCHS=2, RESUME=False,
              CHECKPOINT_ITER=False, FUSED_BUCKETS=3)
    infos = []
    orig = TrainingStrategy._fused_train

    def spy(self, *a):
        out = orig(self, *a)
        infos.append(dict(self._fused_info))
        return out

    monkeypatch.setattr(TrainingStrategy, "_fused_train", spy)
    with caplog.at_level(logging.INFO):
        _grip(tmp_path / "port", ckpt, port_rt, data_root, FUSED_BUCKETS=3)
        jcfg = JaxConfig(**{k: v for k, v in vars(_cfg(tmp_path / "jax", ckpt, **kw)).items()
                            if k != "extras"})
        _, train, val, pool = _datasets(data_root, n_train=2, n_val=1, dataset=jax_dataset_object)
        jstrat = JaxTextualStrategy(jcfg, {c: i for i, c in enumerate(CLASSES)}, CLASSES,
                                    CLASSES, CLASSES, data_folder=str(data_root),
                                    unlabeled_files=[f.split("/")[-1] for f in pool.filepaths],
                                    runtime=jax_rt)
        jstrat.grip_train(train, val, pool)
    assert [(i["steps_per_epoch"], i["slot_steps"]) for i in infos] == [(3, 3), (2, 3)]
    port = _logged_final_losses(caplog, "menghini_neurips23_tpu_torch.training.strategy")
    want = _logged_final_losses(caplog, "menghini_neurips23_tpu.training.strategy")
    assert len(port) == len(want) == 2
    assert want[1] == port[1] == 0.0 and want[0] > 0
    assert port[0] == pytest.approx(want[0], abs=2e-4)
    # the port's own stats keep the last real batch's loss
    assert infos[1]["stats"][2, -1] > 0


def _count_calls(monkeypatch):
    """Count the program's step and epoch-end calls (on the CPU, each is
    what a replay is on the card)."""
    from menghini_neurips23_tpu_torch.training.fused import FusedProgram

    calls = {"step": 0, "epoch_end": 0}
    for name in calls:
        def counted(self, _f=getattr(FusedProgram, name), _n=name):
            calls[_n] += 1
            _f(self)

        monkeypatch.setattr(FusedProgram, name, counted)
    return calls


def test_padded_slot_runs_only_real_batches(tmp_path, ckpt, port_rt, data_root, monkeypatch):
    """FUSED_BUCKETS=1 puts both GRIP iterations' training sets (17 and 30
    rows) into the full-pool slot of 33 rows (5 batches of 8); each run
    takes only its real batches, ceil(n / 8) a epoch, and its 2 epoch ends."""
    calls = _count_calls(monkeypatch)
    runs = []
    orig = TrainingStrategy._fused_train

    def spy(self, epoch, *a):
        before = dict(calls)
        out = orig(self, epoch, *a)
        runs.append((len(epoch), self._fused_info, calls["step"] - before["step"],
                     calls["epoch_end"] - before["epoch_end"]))
        return out

    monkeypatch.setattr(TrainingStrategy, "_fused_train", spy)
    _grip(tmp_path, ckpt, port_rt, data_root, FUSED_BUCKETS=1)
    assert [n for n, *_ in runs] == [17, 30]
    for n, info, steps, ends in runs:
        assert info["slot_steps"] == 5 and info["steps_per_epoch"] == -(-n // 8)
        assert (steps, ends) == (2 * info["steps_per_epoch"], 2)


def test_chunk_padding_epochs_are_not_run(tmp_path, ckpt, port_rt, data_root, monkeypatch):
    """FUSED_EPOCH_CHUNK=2 over 5 epochs pads a sixth, all-padding epoch into
    the permutations, as the JAX package does; it would change nothing, so
    it is not run: 5 epoch ends of 3 steps, 5 columns of stats."""
    calls = _count_calls(monkeypatch)
    strat, _, _ = _train("coop", tmp_path, ckpt, port_rt, data_root, EPOCHS=5,
                         FUSED_EPOCH_CHUNK=2, CHECKPOINT_ITER=False)
    assert calls == {"step": 15, "epoch_end": 5}
    assert strat._fused_info["stats"].shape == (3, 5)


def test_killed_chunk_resumes_bit_identical(tmp_path, ckpt, port_rt, data_root, monkeypatch):
    """A GRIP run with FUSED_EPOCH_CHUNK=2 over 4 epochs, killed after its
    first chunk by MNT_FAIL_AFTER_CHUNK=1, leaves one chunk state and no
    iteration; resumed by a fresh strategy it skips that chunk and ends bit
    for bit as an uninterrupted run."""
    kw = dict(EPOCHS=4, FUSED_EPOCH_CHUNK=2, MOMENTUM=0.9)
    cfg_kw = dict(MODEL="grip_textual", STEP_QUANTILE=50, CHECKPOINT_ITER=True, RESUME=True,
                  **kw)

    def run(path):
        cfg = _cfg(path, ckpt, **cfg_kw)
        _, train, val, pool = _datasets(data_root)
        strat = _strategy(TextualStrategy, cfg, port_rt, data_root, pool)
        return strat, cfg, (lambda: strat.grip_train(train, val, pool))

    _, _, whole = run(tmp_path / "a")
    acc_a, params_a = whole()
    _, cfg_b, cut = run(tmp_path / "b")
    monkeypatch.setenv("MNT_FAIL_AFTER_CHUNK", "1")
    with pytest.raises(RuntimeError, match="fault injection: MNT_FAIL_AFTER_CHUNK=1"):
        cut()
    monkeypatch.delenv("MNT_FAIL_AFTER_CHUNK")
    assert len(glob.glob(str(tmp_path / "b" / "checkpoints" / "*" / "chunk_*.pt"))) == 1
    assert latest_iteration_state(cfg_b) is None
    strat_c, _, resumed = run(tmp_path / "b")
    runs = []
    orig = strat_c._fused_chunked_call

    def spy(prog, *a):
        out = orig(prog, *a)
        runs.append(prog.ei.item())  # the epoch counter after the run
        return out

    strat_c._fused_chunked_call = spy
    acc_c, params_c = resumed()
    assert acc_c == acc_a
    _equal(params_c, params_a)
    assert runs == [4, 4]  # both iterations ran to their fourth epoch
    assert glob.glob(str(tmp_path / "b" / "checkpoints" / "*" / "chunk_*.pt")) == []
    for it in (1, 2):
        from menghini_neurips23_tpu_torch.evaluation.persist import load_saved_parameters

        _equal(load_saved_parameters(cfg_b, it),
               load_saved_parameters(_cfg(tmp_path / "a", ckpt, **cfg_kw), it))


def test_repeated_runs_upload_only_what_changed(tmp_path, ckpt, port_rt, data_root):
    """Two train() calls on one training set with the program kept (as in
    IFPL/GRIP): the second uploads only the new permutation matrix."""
    strat = _strategy(TextualStrategy, _cfg(tmp_path, ckpt), port_rt, data_root)
    strat._fused_keep = True
    _, train, val, _ = _datasets(data_root)
    strat.train(copy.deepcopy(train), copy.deepcopy(val), only_seen=True)
    (prog,) = strat._fused_cache.values()
    first = prog.uploads
    strat.initialize_prompts_parameters()
    strat.train(copy.deepcopy(train), copy.deepcopy(val), only_seen=True)
    assert list(strat._fused_cache.values()) == [prog] and strat._fused_builds == 1
    assert first == len(prog.buf) and prog.uploads == first + 1


# ----------------------------------------------------------------- fallbacks
@pytest.mark.parametrize("case", ["disabled", "empty_train", "empty_val", "too_large",
                                  "transform"])
def test_fallback_reasons_take_the_per_step_loop(tmp_path, ckpt, port_rt, data_root, caplog,
                                                 case):
    kw = {"disabled": dict(FUSED_TRAIN=False), "too_large": dict(FUSED_MAX_BYTES=0)}.get(case, {})
    strat = _strategy(TextualStrategy, _cfg(tmp_path, ckpt, **kw), port_rt, data_root)
    _, train, val, _ = _datasets(data_root)
    if case == "transform":
        train.transform = val.transform = lambda img: img
        strat._note_transform(train)
    epoch = strat._prepare_epoch_data(train, CLASSES, True)
    vdata = strat._prepare_val_data(val)
    if case == "empty_train":
        epoch = EpochData(epoch.features[:0], [], [], [])
    if case == "empty_val":
        vdata = ([], vdata[1][:0], vdata[2])
    with caplog.at_level(logging.WARNING):
        assert strat._fused_train(epoch, vdata, CLASSES) is None
    reason = {"disabled": "FUSED_TRAIN disabled", "empty_train": "empty training set",
              "empty_val": "empty validation set", "too_large": "exceed FUSED_MAX_BYTES/2",
              "transform": "an active dataset transform"}[case]
    assert f"fused training unavailable ({reason}" in caplog.text or reason in caplog.text
    assert "falling back to the dispatch-per-step host loop" in caplog.text
    assert getattr(strat, "_fused_builds", 0) == 0
    if case in ("disabled", "too_large"):
        steps = []
        orig = TrainingStrategy._apply_step

        def counted(self, *a, **k):
            steps.append(1)
            return orig(self, *a, **k)

        strat._apply_step = counted.__get__(strat)
        strat.train(train, val, only_seen=True)
        assert len(steps) == 3 * 3 and not hasattr(strat, "_fused_info")
