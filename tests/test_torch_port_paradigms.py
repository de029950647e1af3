"""The port's paradigm runners against the JAX package, on the CPU, at the
tiny-test width: whole SSL workflows of the VPT models, and whole UL and
TRZSL workflows of the CoOp and VPT models, on the synthetic MNIST fixture;
then `main_ul.main` / `main_trzsl.main` on the CPU and without a card.

Weights cross between the packages through one OpenAI-layout .pt that both
`load_clip`s read.  The initial prompt is the JAX package's jax.random draw,
carried across (the port draws from a torch.Generator, which cannot reproduce
it): the port's init functions are patched to return it for the same seed.

Tolerances, those of the CoOp workflow test (test_torch_port_train.py): the
saved prompts 1e-4 and logits 2e-4 (rounding carried through several steps);
pseudolabel caches, the best validation metric, predictions, the artifact
listing and the results line must agree exactly.
"""

import json
import os
import pickle

import jax
import numpy as np
import pytest
import torch

from menghini_neurips23_tpu.config import Config as JaxConfig
from menghini_neurips23_tpu.models import TINY_TEST as JAX_TINY
from menghini_neurips23_tpu.models.prompts import (
    init_deep_prefix as jax_init_deep_prefix,
    init_prefix as jax_init_prefix,
)
from menghini_neurips23_tpu.runners import common as jax_common
from menghini_neurips23_tpu.runners import main_ssl as jax_main_ssl
from menghini_neurips23_tpu.runners import main_trzsl as jax_main_trzsl
from menghini_neurips23_tpu.runners import main_ul as jax_main_ul
from menghini_neurips23_tpu.runtime import ClipRuntime as JaxClipRuntime
from menghini_neurips23_tpu_torch.config import Config
from menghini_neurips23_tpu_torch.runners import common, main_ssl, main_trzsl, main_ul
from menghini_neurips23_tpu_torch.runtime import ClipRuntime
from menghini_neurips23_tpu_torch.training import textual as port_textual
from menghini_neurips23_tpu_torch.training import visual as port_visual
from tests.test_torch_parity import _make_state_dict
from tests.torch_port_fixtures import native_build_outside_checkout  # noqa: F401

torch.set_num_threads(2)

RUNNERS = {
    "ssl": (jax_main_ssl, main_ssl),
    "ul": (jax_main_ul, main_ul),
    "trzsl": (jax_main_trzsl, main_trzsl),
}


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    # seed 16, as the CoOp workflow test: its pool probabilities are free of
    # near-ties
    sd = _make_state_dict(JAX_TINY, np.random.default_rng(16))
    path = tmp_path_factory.mktemp("ckpt") / "tiny_openai.pt"
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, path)
    return str(path)


@pytest.fixture(scope="module")
def runtimes(ckpt):
    jax_rt = JaxClipRuntime(JaxConfig(VIS_ENCODER="tiny-test", BATCH_SIZE=8, CLIP_CKPT=ckpt))
    port_rt = ClipRuntime(Config(VIS_ENCODER="tiny-test", BATCH_SIZE=8, CLIP_CKPT=ckpt), device="cpu")
    return jax_rt, port_rt


def _jax_draws(monkeypatch):
    """Make the port's prompt inits return the JAX package's draws for the
    same seed: CoOp draws from the key itself, VPT splits it into the
    prefix's and the deep prompts' keys."""

    def key(gen):
        return jax.random.PRNGKey(gen.initial_seed())

    def to_torch(x):
        return torch.from_numpy(np.array(x))

    monkeypatch.setattr(
        port_textual, "init_prefix",
        lambda gen, length, dim, init, mean, std: to_torch(
            jax_init_prefix(key(gen), length, dim, init, mean, std)),
    )
    monkeypatch.setattr(
        port_visual, "init_prefix",
        lambda gen, length, dim, init, mean, std: to_torch(
            jax_init_prefix(jax.random.split(key(gen))[0], length, dim, init, mean, std)),
    )
    monkeypatch.setattr(
        port_visual, "init_deep_prefix",
        lambda gen, depth, length, dim, init, mean, std: to_torch(
            jax_init_deep_prefix(jax.random.split(key(gen))[1], depth, length, dim, init, mean,
                                 std)),
    )


def _kw(root, artifact_dir, ckpt, paradigm, model, deep):
    return dict(
        DATASET_NAME="MNIST", DATASET_DIR=str(root.parent), MODEL=model, VIS_ENCODER="tiny-test",
        LEARNING_PARADIGM=paradigm, PROMPT_TEMPLATE="a photo of a {}", BATCH_SIZE=8, EPOCHS=3,
        PREFIX_SIZE=4, N_PSEUDOSHOTS=16, LR=0.1, OPTIM_SEED=1, SPLIT_SEED=500, CLIP_CKPT=ckpt,
        VPT_DEEP=deep, ARTIFACT_DIR=str(artifact_dir),
    )


def _listing(root):
    return sorted(
        os.path.relpath(os.path.join(d, f), root) for d, _, fs in os.walk(root) for f in fs
    )


def _margins(logits):
    top2 = np.sort(logits, axis=1)[:, -2:]
    return top2[:, 1] - top2[:, 0]


def _load(path):
    with open(path, "rb") as f:
        return pickle.load(f)


# (paradigm, MODEL, VPT_DEEP): the VPT models through every runner, shallow
# and deep, and CoOp through the two runners it had not been held to
WORKFLOW_CASES = [
    ("ssl", "visual_prompt", False),
    ("ssl", "visual_fpl", True),
    ("ul", "textual_fpl", False),
    ("ul", "visual_fpl", False),
    ("ul", "visual_fpl", True),
    ("trzsl", "textual_fpl", False),
    ("trzsl", "visual_fpl", False),
    ("trzsl", "visual_fpl", True),
]


@pytest.mark.parametrize(
    "paradigm, model, deep", WORKFLOW_CASES,
    ids=[f"{p}-{m}" + ("-deep" if d else "") for p, m, d in WORKFLOW_CASES],
)
def test_workflow_matches_jax(tmp_path, mnist_fixture, runtimes, ckpt, monkeypatch,
                              paradigm, model, deep):
    root, _ = mnist_fixture
    jax_rt, port_rt = runtimes
    _jax_draws(monkeypatch)
    results = {}

    def spy(mod, key):
        run = mod.run_strategy

        def wrapped(strategy, *a):
            results[key] = (strategy, run(strategy, *a))
            return results[key][1]

        monkeypatch.setattr(mod, "run_strategy", wrapped)

    spy(jax_common, "jax")
    spy(common, "port")
    jmod, pmod = RUNNERS[paradigm]
    jcfg = JaxConfig(**_kw(root, tmp_path / "jax", ckpt, paradigm, model, deep))
    pcfg = Config(**_kw(root, tmp_path / "port", ckpt, paradigm, model, deep))
    jresp = jmod.workflow(jcfg.DATASET_DIR, jcfg, runtime=jax_rt)
    presp = pmod.workflow(pcfg.DATASET_DIR, pcfg, runtime=port_rt)

    jstrat, (jbest, jparams) = results["jax"]
    pstrat, (pbest, pparams) = results["port"]
    assert pbest == pytest.approx(jbest, abs=1e-6)  # TRZSL: the harmonic mean
    visual = model.startswith("visual")
    assert len(pparams) == len(jparams) == (2 if deep else 1)
    for p, j in zip(pparams, jparams):
        np.testing.assert_allclose(p, np.asarray(j), rtol=1e-4, atol=1e-4)
    assert _listing(tmp_path / "port") == _listing(tmp_path / "jax")

    stem = f"MNIST_{paradigm}_{model}_tiny-test_opt_1_spl_500.pickle"
    saved = _load(tmp_path / "port" / "trained_prompts" / stem)
    W = JAX_TINY.vision_width if visual else JAX_TINY.transformer_width
    shapes = [(4, W)] + ([(JAX_TINY.vision_layers - 1, 4, W)] if deep else [])
    assert [s.shape for s in saved] == shapes and all(s.dtype == np.float32 for s in saved)
    for s, p in zip(saved, pparams):
        np.testing.assert_array_equal(s, p)

    if model.endswith("fpl"):
        caches = [f for f in _listing(tmp_path / "port") if f.startswith("pseudolabels/")]
        assert len(caches) == 1
        assert _load(tmp_path / "port" / caches[0]) == _load(tmp_path / "jax" / caches[0])
        assert list(pstrat.val_unseen_files) == list(jstrat.val_unseen_files)
        assert list(pstrat.val_unseen_labs) == list(jstrat.val_unseen_labs)
        assert pstrat._train_groups == jstrat._train_groups
        if paradigm == "ul":
            # UL trains on pseudolabels only: the 80% carve of the pool
            n_pool = len(pstrat.val_unseen_files) + len(pstrat._train_groups)
            assert sum(pstrat._train_groups) == 0
            assert len(pstrat._train_groups) == int(n_pool * pcfg.ratio_train_val)
        else:
            assert 1 in pstrat._train_groups

    jpred = _load(tmp_path / "jax" / "evaluation" / stem)
    ppred = _load(tmp_path / "port" / "evaluation" / stem)
    margin = _margins(np.asarray(jpred["logits"])).min()
    assert margin > 1e-3, f"near-tie in the reference's test logits: margin {margin}"
    for key in ("images", "predictions", "labels"):
        assert ppred[key] == jpred[key], f"{key} differ (smallest logit margin {margin})"
    np.testing.assert_allclose(ppred["logits"], jpred["logits"], rtol=2e-4, atol=2e-4)
    np.testing.assert_equal(presp, jresp)
    jrec = json.loads((tmp_path / "jax" / f"results_model_{model}.json").read_text())
    prec = json.loads((tmp_path / "port" / f"results_model_{model}.json").read_text())
    assert prec.keys() == jrec.keys() and prec["config"].keys() == jrec["config"].keys()
    np.testing.assert_equal({k: v for k, v in prec.items() if k != "config"},
                            {k: v for k, v in jrec.items() if k != "config"})
    if paradigm == "trzsl":
        assert {"harmonic_mean", "seen_accuracy", "unseen_accuracy"} <= set(prec)
    # the live strategy keeps the final epoch's prompt, as the reference does
    for p, j in zip(pstrat.epoch_parameters(), jstrat.epoch_parameters()):
        np.testing.assert_allclose(p, np.asarray(j), rtol=1e-4, atol=1e-4)


# (runner, MODEL, VPT_DEEP): each runner with the model pairs the JAX
# comparison above does not take through it
CLI_CASES = [
    ("ul", "textual_prompt", False),
    ("ul", "visual_prompt", False),
    ("ul", "visual_prompt", True),
    ("trzsl", "textual_prompt", False),
    ("trzsl", "visual_prompt", False),
    ("trzsl", "visual_prompt", True),
]


@pytest.mark.parametrize(
    "paradigm, model, deep", CLI_CASES,
    ids=[f"{p}-{m}" + ("-deep" if d else "") for p, m, d in CLI_CASES],
)
def test_main_runs_on_the_cpu_when_asked(tmp_path, mnist_fixture, ckpt, monkeypatch,
                                         paradigm, model, deep):
    root, _ = mnist_fixture
    monkeypatch.chdir(tmp_path)
    env = dict(DATASET_NAME="MNIST", DATASET_DIR=str(root.parent), MODEL=model,
               VIS_ENCODER="tiny-test", OPTIM_SEED="1", SPLIT_SEED="500", CLIP_CKPT=ckpt,
               ARTIFACT_DIR=str(tmp_path))
    yml = tmp_path / "c.yml"
    yml.write_text(f"BATCH_SIZE: 8\nEPOCHS: 2\nPREFIX_SIZE: 4\nVPT_DEEP: {str(deep).lower()}\n")
    argv = ["--model_config", str(yml), "--learning_paradigm", paradigm]
    runner = RUNNERS[paradigm][1]
    resp = runner.main(argv, env=env, device="cpu")
    # UL reports the accuracy alone, TRZSL unseen, seen and their harmonic mean
    assert len(resp) == 3 and 0.0 <= resp[0] <= 1.0
    if paradigm == "ul":
        assert resp[1:] == (None, None)
    else:
        assert all(0.0 <= r <= 1.0 or np.isnan(r) for r in resp[1:])
    stem = f"MNIST_{paradigm}_{model}_tiny-test_opt_1_spl_500.pickle"
    saved = _load(tmp_path / "trained_prompts" / stem)
    assert len(saved) == (2 if deep else 1)
    assert saved[0].shape == (4, 32)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        runner.main(argv, env=env)
