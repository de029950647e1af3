"""The port's CoOp training slice against the JAX package, on the CPU, at the
tiny-test width: the prompt ops, the loss, the lr schedule, the loss policy,
one SGD step, the artifacts, and whole SSL `textual_prompt` / `textual_fpl`
workflows.

Weights cross between the packages through one OpenAI-layout .pt that both
`load_clip`s read, or through `from_jax_params`.  The initial prefix is the
JAX package's jax.random draw, carried across (the port draws from a
torch.Generator, which cannot reproduce it).

Tolerances: text features 2e-4 (fp32, as the model parity tests); loss,
correct count and updated prefix after a step 1e-5 (fp32; the JAX side
differentiates XLA attention, the port its plain backward, equal to
rounding); the saved prefix after a workflow 1e-4 and logits 2e-4 (rounding
carried through several steps).  Argmax decisions - predictions, best-epoch
choice, pseudolabel sets - must be identical, and the tests report the margin
when one is close.
"""

import json
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from menghini_neurips23_tpu.config import Config as JaxConfig
from menghini_neurips23_tpu.evaluation import persist as jax_persist
from menghini_neurips23_tpu.models import TINY_TEST as JAX_TINY
from menghini_neurips23_tpu.models import init_clip_params as jax_init_clip_params
from menghini_neurips23_tpu.models.prompts import (
    build_prompt_token_ids as jax_build_prompt_token_ids,
    coop_text_features as jax_coop_text_features,
    init_prefix as jax_init_prefix,
)
from menghini_neurips23_tpu.runners import common as jax_common
from menghini_neurips23_tpu.runners import main_ssl as jax_main_ssl
from menghini_neurips23_tpu.runtime import ClipRuntime as JaxClipRuntime
from menghini_neurips23_tpu.tokenizer import get_tokenizer as jax_get_tokenizer
from menghini_neurips23_tpu.training import TextualStrategy as JaxTextualStrategy
from menghini_neurips23_tpu.training.losses import two_group_loss as jax_two_group_loss
from menghini_neurips23_tpu.training.schedulers import lr_for_epoch as jax_lr_for_epoch
from menghini_neurips23_tpu_torch.config import Config
from menghini_neurips23_tpu_torch.data import prepare
from menghini_neurips23_tpu_torch.evaluation import persist
from menghini_neurips23_tpu_torch.models import TINY_TEST, build_clip, from_jax_params
from menghini_neurips23_tpu_torch.models.prompts import (
    build_prompt_token_ids,
    coop_text_features,
    init_prefix,
    truncate_context,
)
from menghini_neurips23_tpu_torch.ops.attention import attention_bwd, fused_attention
from menghini_neurips23_tpu_torch.runners import common, main_ssl
from menghini_neurips23_tpu_torch.runtime import ClipRuntime
from menghini_neurips23_tpu_torch.tokenizer import get_tokenizer
from menghini_neurips23_tpu_torch.training import TextualStrategy, TrainingStrategy, strategy_class
from menghini_neurips23_tpu_torch.training import textual as port_textual
from menghini_neurips23_tpu_torch.training.losses import two_group_loss
from menghini_neurips23_tpu_torch.training.schedulers import lr_for_epoch
from tests.test_torch_parity import _make_state_dict
from tests.torch_port_fixtures import native_build_outside_checkout  # noqa: F401

torch.set_num_threads(2)

CLASSES = ["0", "1", "2"]
FRAMED = ("EuroSAT", "DTD", "RESICS45", "FGVCAircraft", "MNIST", "Flowers102")


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    # seed 16, as the zero-shot slice test: its pool probabilities are free
    # of near-ties
    sd = _make_state_dict(JAX_TINY, np.random.default_rng(16))
    path = tmp_path_factory.mktemp("ckpt") / "tiny_openai.pt"
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, path)
    return str(path)


@pytest.fixture(scope="module")
def runtimes(ckpt):
    jax_rt = JaxClipRuntime(JaxConfig(VIS_ENCODER="tiny-test", BATCH_SIZE=8, CLIP_CKPT=ckpt))
    port_rt = ClipRuntime(Config(VIS_ENCODER="tiny-test", BATCH_SIZE=8, CLIP_CKPT=ckpt), device="cpu")
    return jax_rt, port_rt


def _jax_prefix(seed: int, length: int, dim: int) -> np.ndarray:
    return np.asarray(jax_init_prefix(jax.random.PRNGKey(seed), length, dim))


# ------------------------------------------------------------------ prompts
@pytest.mark.parametrize("dataset", FRAMED)
def test_prompt_token_ids_match_jax(tmp_path, dataset):
    """The CoOp 'X X .. X <class>' frame through the port's tokenizer gives the
    JAX tokenizer's ids for every class list of the framed datasets."""
    classes = prepare.get_class_names(dataset, str(tmp_path), 500)[0]
    for prefix_len in (4, 16):
        got = build_prompt_token_ids(get_tokenizer(None), classes, prefix_len)
        want = jax_build_prompt_token_ids(jax_get_tokenizer(None), classes, prefix_len)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(truncate_context(got), truncate_context(want))


def test_coop_text_features_and_prefix_gradient_match_jax():
    model, params = jax_init_clip_params(JAX_TINY, seed=0)
    params = jax.tree.map(np.asarray, params)
    port = build_clip(TINY_TEST, from_jax_params(params))
    L = 4
    ids = truncate_context(
        jax_build_prompt_token_ids(jax_get_tokenizer(None), ["cat", "sea_lion", "tree"], L)
    )
    prefix = _jax_prefix(7, L, JAX_TINY.transformer_width)
    rng = np.random.default_rng(0)
    w = rng.normal(0, 1, (3, JAX_TINY.embed_dim)).astype(np.float32)

    def jax_feats(p):
        return jax_coop_text_features(model, params, p, jnp.asarray(ids))

    want_feats, vjp = jax.vjp(jax.jit(jax_feats), jnp.asarray(prefix))
    (want_grad,) = vjp(jnp.asarray(w))
    want_feats = np.asarray(want_feats)

    p = torch.from_numpy(prefix.copy()).requires_grad_(True)
    emb_table = port.text.token_embedding.weight.detach().clone()
    feats = coop_text_features(port, p, torch.from_numpy(ids.astype(np.int64)))
    (feats * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(feats.detach().numpy(), want_feats, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(p.grad.numpy(), np.asarray(want_grad), rtol=2e-4, atol=2e-5)
    # the splice is out of place: the embedding table is untouched and
    # gathers no gradient
    torch.testing.assert_close(port.text.token_embedding.weight, emb_table, rtol=0, atol=0)
    assert all(q.grad is None for q in port.parameters())


@pytest.mark.parametrize("init", ["normal", "uniform"])
def test_init_prefix_draws_from_the_generator(init):
    a = init_prefix(torch.Generator().manual_seed(1000), 16, 32, init, 0.0, 0.02)
    b = init_prefix(torch.Generator().manual_seed(1000), 16, 32, init, 0.0, 0.02)
    c = init_prefix(torch.Generator().manual_seed(1001), 16, 32, init, 0.0, 0.02)
    assert a.shape == (16, 32) and a.dtype == torch.float32
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert not torch.equal(a, c)
    if init == "uniform":
        assert a.abs().max() <= 0.02
    else:
        assert 0.01 < a.std().item() < 0.03
    with pytest.raises(ValueError, match="Unknown prefix init"):
        init_prefix(torch.Generator(), 2, 2, "zeros")


# ------------------------------------------------------- losses, schedules
LOSS_CASES = {
    # (labels, group, valid, w0, w1)
    "two-groups": ([0, 2, 1, 1, 0, 2], [0, 1, 1, 0, 1, 0], [1, 1, 1, 1, 1, 1], 2.5, 1.0),
    "empty-pseudo-group": ([0, 2, 1, 1, 0, 2], [0, 0, 0, 0, 0, 0], [1, 1, 1, 1, 1, 1], 1.0, 1.0),
    "padded-rows": ([0, 2, 1, -1, -1, -1], [1, 0, 1, 0, 0, 0], [1, 1, 1, 0, 0, 0], 1.0, 0.5),
    "nothing-valid": ([-1, -1, -1, -1, -1, -1], [0, 1, 0, 1, 0, 1], [0, 0, 0, 0, 0, 0], 1.0, 1.0),
}


@pytest.mark.parametrize("case", sorted(LOSS_CASES))
def test_two_group_loss_matches_jax(case):
    labels, group, valid, w0, w1 = LOSS_CASES[case]
    logits = np.random.default_rng(3).normal(0, 5, (6, 3)).astype(np.float32)
    lab, grp, val = (np.asarray(x, np.int32) for x in (labels, group, valid))
    want = jax_two_group_loss(jnp.asarray(logits), jnp.asarray(lab), jnp.asarray(grp),
                              jnp.asarray(val, jnp.float32), np.float32(w0), np.float32(w1))
    got = two_group_loss(torch.from_numpy(logits), torch.from_numpy(lab), torch.from_numpy(grp),
                         torch.from_numpy(val.astype(np.float32)), w0, w1)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6, atol=1e-6)
    if case == "nothing-valid":
        assert got.item() == 0.0


@pytest.mark.parametrize("scheduler", ["cosine", "one_warmup_epoch", "step"])
def test_lr_for_epoch_matches_jax(scheduler):
    kw = dict(SCHEDULER=scheduler, LR=0.1, EPOCHS=30, WARMUP_EPOCHS=5, WARMUP_LR=1e-4,
              STEP_SIZE=7)
    got = [lr_for_epoch(Config(**kw), e) for e in range(30)]
    want = [jax_lr_for_epoch(JaxConfig(**kw), e) for e in range(30)]
    assert got == want
    if scheduler == "cosine":
        assert got[0] == 0.0  # the reference's LambdaLR quirk: epoch 0 at lr 0


@pytest.mark.parametrize("paradigm", ["ssl", "ul", "trzsl"])
def test_loss_policy_matches_jax(paradigm):
    got, want = object.__new__(TextualStrategy), object.__new__(JaxTextualStrategy)
    got.config = Config(LEARNING_PARADIGM=paradigm, MODEL="textual_fpl")
    want.config = JaxConfig(LEARNING_PARADIGM=paradigm, MODEL="textual_fpl")
    for n_pseudo, n_labeled in ((128, 16), (0, 16), (12, 0)):
        got._set_loss_policy(n_pseudo, n_labeled)
        want._set_loss_policy(n_pseudo, n_labeled)
        assert (got._w0, got._w1, got.balance_param) == (want._w0, want._w1, want.balance_param)


# ------------------------------------------------------------------ one step
def _strategies(runtimes, tmp_path, **kw):
    jax_rt, port_rt = runtimes
    base = dict(VIS_ENCODER="tiny-test", MODEL="textual_fpl", PREFIX_SIZE=4, BATCH_SIZE=8,
                OPTIM_SEED=1, ARTIFACT_DIR=str(tmp_path), **kw)
    l2i = {c: i for i, c in enumerate(CLASSES)}
    jstrat = JaxTextualStrategy(JaxConfig(**base), l2i, CLASSES, CLASSES, CLASSES, runtime=jax_rt)
    pstrat = TextualStrategy(Config(**base), l2i, CLASSES, CLASSES, CLASSES, runtime=port_rt)
    # the same starting prompt: the JAX package's draw
    pstrat.load_parameters(jstrat.epoch_parameters())
    return jstrat, pstrat


@pytest.mark.parametrize("momentum", [0.0, 0.9], ids=["sgd", "momentum"])
@pytest.mark.parametrize("accum", [1, 2], ids=["accum1", "accum2"])
def test_train_step_matches_jax(runtimes, tmp_path, accum, momentum):
    """Four batches through the port's step and the JAX package's
    `_make_step`: loss, correct count and prefix after every step."""
    jstrat, pstrat = _strategies(runtimes, tmp_path, ACCUMULATION_ITER=accum, MOMENTUM=momentum,
                                 DECAY=0.1)
    for s in (jstrat, pstrat):
        s._w0, s._w1 = 2.0, 1.0
    ctx = np.asarray(pstrat._train_text_class_ids(CLASSES))
    np.testing.assert_array_equal(ctx, jstrat._train_text_class_ids(CLASSES))
    step = jstrat._make_step(len(CLASSES))
    jstrat._init_opt_state()
    pstrat._init_opt_state()
    rng = np.random.default_rng(5)
    E = JAX_TINY.embed_dim
    for i in range(4):
        feats = rng.normal(0, 1, (8, E)).astype(np.float32)
        feats /= np.linalg.norm(feats, axis=1, keepdims=True)
        labels = rng.integers(0, 3, 8).astype(np.int32)
        group = rng.integers(0, 2, 8).astype(np.int32)
        valid = np.ones(8, np.float32)
        if i == 3:  # a padded last batch
            labels[5:], valid[5:] = -1, 0.0
        lr = 0.05 * (i + 1)
        apply = (i + 1) % accum == 0
        want = jstrat._apply_step(step, ctx, lr, feats, labels, group, valid, apply=apply)
        got = pstrat._apply_step(
            torch.from_numpy(ctx.astype(np.int64)), lr, torch.from_numpy(feats),
            torch.from_numpy(labels), torch.from_numpy(group), torch.from_numpy(valid),
            apply=apply,
        )
        np.testing.assert_allclose(got[0], want[0], rtol=1e-5, atol=1e-5)
        assert got[1] == want[1]
        np.testing.assert_allclose(
            pstrat.epoch_parameters()[0], np.asarray(jstrat.prefix), rtol=1e-5, atol=1e-5
        )
    assert not np.allclose(pstrat.epoch_parameters()[0], _jax_prefix(1000, 4, JAX_TINY.transformer_width))
    # the frozen CLIP gathers no gradient; only the prefix is a leaf with one
    assert all(p.grad is None for p in pstrat.runtime.model.parameters())


def test_bf16_step_keeps_weights_precast_and_frozen(ckpt, tmp_path):
    cfg = Config(VIS_ENCODER="tiny-test", MODEL="textual_prompt", PREFIX_SIZE=4, BATCH_SIZE=8,
                 CLIP_CKPT=ckpt, COMPUTE_DTYPE="bfloat16", ARTIFACT_DIR=str(tmp_path))
    strat = TextualStrategy(cfg, {c: i for i, c in enumerate(CLASSES)}, CLASSES, CLASSES,
                            CLASSES, device="cpu")
    blk = strat.runtime.model.text.transformer.resblocks[0]
    assert blk.attn.in_proj_weight.dtype == torch.bfloat16
    before = strat.epoch_parameters()[0]
    fused_attention.launches = attention_bwd.launches = 0
    feats = torch.nn.functional.normalize(torch.randn(8, TINY_TEST.embed_dim), dim=1)
    ctx = torch.from_numpy(np.asarray(strat._train_text_class_ids(CLASSES)).astype(np.int64))
    labels = torch.tensor([0, 1, 2, 0, 1, 2, 0, 1], dtype=torch.int32)
    loss, _ = strat._apply_step(ctx, 0.1, feats, labels, torch.zeros(8, dtype=torch.int32),
                                torch.ones(8))
    assert np.isfinite(loss)
    assert strat.prefix.dtype == torch.float32 and strat.prefix.requires_grad
    assert not np.array_equal(strat.epoch_parameters()[0], before)
    assert blk.attn.in_proj_weight.dtype == torch.bfloat16
    assert all(p.grad is None for p in strat.runtime.model.parameters())
    # CPU tensors take the plain versions: no kernel launch is counted
    assert fused_attention.launches == 0 and attention_bwd.launches == 0


# ------------------------------------------------------------------ persist
@pytest.mark.parametrize("fmt", ["numpy", "torch"])
def test_prompt_artifact_matches_jax_and_round_trips(runtimes, tmp_path, fmt):
    jstrat, pstrat = _strategies(runtimes, tmp_path, ARTIFACT_FORMAT=fmt)
    params = pstrat.epoch_parameters()
    kw = dict(VIS_ENCODER="tiny-test", MODEL="textual_fpl", ARTIFACT_FORMAT=fmt)
    jcfg = JaxConfig(ARTIFACT_DIR=str(tmp_path / "jax"), **kw)
    pcfg = Config(ARTIFACT_DIR=str(tmp_path / "port"), **kw)
    jax_persist.save_parameters(params, jcfg)
    persist.save_parameters(params, pcfg)
    rel = "trained_prompts/_ssl_textual_fpl_tiny-test_opt_1_spl_500.pickle"
    assert os.path.relpath(persist._prompt_file_name(pcfg), pcfg.ARTIFACT_DIR) == rel
    assert os.path.relpath(jax_persist._prompt_file_name(jcfg), jcfg.ARTIFACT_DIR) == rel
    with open(tmp_path / "port" / rel, "rb") as f:
        got = pickle.load(f)
    with open(tmp_path / "jax" / rel, "rb") as f:
        want = pickle.load(f)
    assert type(got) is type(want) and len(got) == len(want) == 1
    assert type(got[0]) is type(want[0])
    if fmt == "torch":
        assert tuple(got[0].shape) == (1, 4, JAX_TINY.transformer_width)
    np.testing.assert_array_equal(np.asarray(got[0]), np.asarray(want[0]))
    # each package reads the other's artifact back into the same prefix
    pstrat.config.ARTIFACT_DIR = str(tmp_path / "jax")
    pstrat.config.ARTIFACT_FORMAT = fmt
    with torch.no_grad():
        pstrat.prefix.zero_()
    pstrat.load_model_eval()
    np.testing.assert_array_equal(pstrat.epoch_parameters()[0], params[0])
    jcfg.ARTIFACT_DIR = str(tmp_path / "port")
    jstrat.config = jcfg
    jstrat.load_model_eval()
    np.testing.assert_array_equal(np.asarray(jstrat.prefix), params[0])


# ------------------------------------------------------------ whole workflow
def _slice_kw(root, artifact_dir, ckpt, model):
    return dict(
        DATASET_NAME="MNIST", DATASET_DIR=str(root.parent), MODEL=model, VIS_ENCODER="tiny-test",
        LEARNING_PARADIGM="ssl", PROMPT_TEMPLATE="a photo of a {}", BATCH_SIZE=8, EPOCHS=3,
        PREFIX_SIZE=4, N_PSEUDOSHOTS=16, LR=0.1, OPTIM_SEED=1, SPLIT_SEED=500, CLIP_CKPT=ckpt,
        ARTIFACT_DIR=str(artifact_dir),
    )


def _listing(root):
    return sorted(
        os.path.relpath(os.path.join(d, f), root) for d, _, fs in os.walk(root) for f in fs
    )


def _margins(logits):
    top2 = np.sort(logits, axis=1)[:, -2:]
    return top2[:, 1] - top2[:, 0]


@pytest.mark.parametrize("model", ["textual_prompt", "textual_fpl"])
def test_main_ssl_workflow_matches_jax(tmp_path, mnist_fixture, runtimes, ckpt, monkeypatch, model):
    root, _ = mnist_fixture
    jax_rt, port_rt = runtimes
    # the port's prefix init returns the JAX package's draw for the same key
    monkeypatch.setattr(
        port_textual, "init_prefix",
        lambda gen, length, dim, init, mean, std: torch.from_numpy(
            np.array(jax_init_prefix(jax.random.PRNGKey(gen.initial_seed()), length, dim,
                                       init, mean, std))
        ),
    )
    results = {}

    def spy(mod, key):
        run = mod.run_strategy

        def wrapped(strategy, *a):
            results[key] = (strategy, run(strategy, *a))
            return results[key][1]

        monkeypatch.setattr(mod, "run_strategy", wrapped)

    spy(jax_common, "jax")
    spy(common, "port")
    jcfg = JaxConfig(**_slice_kw(root, tmp_path / "jax", ckpt, model))
    pcfg = Config(**_slice_kw(root, tmp_path / "port", ckpt, model))
    jresp = jax_main_ssl.workflow(jcfg.DATASET_DIR, jcfg, runtime=jax_rt)
    presp = main_ssl.workflow(pcfg.DATASET_DIR, pcfg, runtime=port_rt)

    jstrat, (jbest, jparams) = results["jax"]
    pstrat, (pbest, pparams) = results["port"]
    assert pbest == pytest.approx(jbest, abs=1e-6)  # the JAX side returns an fp32 metric
    np.testing.assert_allclose(pparams[0], np.asarray(jparams[0]), rtol=1e-4, atol=1e-4)
    assert _listing(tmp_path / "port") == _listing(tmp_path / "jax")
    stem = f"MNIST_ssl_{model}_tiny-test_opt_1_spl_500.pickle"
    with open(tmp_path / "port" / "trained_prompts" / stem, "rb") as f:
        saved = pickle.load(f)
    assert saved[0].shape == (4, JAX_TINY.transformer_width) and saved[0].dtype == np.float32
    np.testing.assert_allclose(saved[0], pparams[0], rtol=0, atol=0)
    if model == "textual_fpl":
        name = "pseudolabels/MNIST_tiny-test_ssl_textual_fpl_16_pseudolabels_split_500.pickle"
        with open(tmp_path / "jax" / name, "rb") as f, open(tmp_path / "port" / name, "rb") as g:
            assert pickle.load(g) == pickle.load(f)
        assert list(pstrat.val_unseen_files) == list(jstrat.val_unseen_files)
        assert list(pstrat.val_unseen_labs) == list(jstrat.val_unseen_labs)
        assert pstrat._train_groups == jstrat._train_groups and 1 in pstrat._train_groups

    with open(tmp_path / "jax" / "evaluation" / stem, "rb") as f:
        jpred = pickle.load(f)
    with open(tmp_path / "port" / "evaluation" / stem, "rb") as f:
        ppred = pickle.load(f)
    margin = _margins(np.asarray(jpred["logits"])).min()
    assert margin > 1e-3, f"near-tie in the reference's test logits: margin {margin}"
    for key in ("images", "predictions", "labels"):
        assert ppred[key] == jpred[key], f"{key} differ (smallest logit margin {margin})"
    np.testing.assert_allclose(ppred["logits"], jpred["logits"], rtol=2e-4, atol=2e-4)
    assert presp == jresp
    jrec = json.loads((tmp_path / "jax" / f"results_model_{model}.json").read_text())
    prec = json.loads((tmp_path / "port" / f"results_model_{model}.json").read_text())
    assert prec["accuracy"] == jrec["accuracy"] and prec["config"].keys() == jrec["config"].keys()
    # the live strategy keeps the final epoch's prompt, as the reference does
    np.testing.assert_allclose(
        pstrat.epoch_parameters()[0], np.asarray(jstrat.prefix), rtol=1e-4, atol=1e-4
    )


def test_streaming_epoch_trains_as_the_device_resident_one(tmp_path, mnist_fixture, runtimes, ckpt):
    """FUSED_MAX_BYTES=0 streams each batch's features through the host
    cache instead of keeping the epoch on the device: the same prefix."""
    root, _ = mnist_fixture
    _, port_rt = runtimes
    saved = {}
    for name, extra in (("resident", {}), ("streaming", {"FUSED_MAX_BYTES": 0})):
        cfg = Config(**_slice_kw(root, tmp_path / name, ckpt, "textual_fpl"), **extra)
        main_ssl.workflow(cfg.DATASET_DIR, cfg, runtime=port_rt)
        stem = "MNIST_ssl_textual_fpl_tiny-test_opt_1_spl_500.pickle"
        with open(tmp_path / name / "trained_prompts" / stem, "rb") as f:
            saved[name] = pickle.load(f)[0]
    np.testing.assert_array_equal(saved["streaming"], saved["resident"])


def test_main_ssl_cli_runs_on_the_cpu_when_asked(tmp_path, mnist_fixture, ckpt, monkeypatch):
    root, _ = mnist_fixture
    monkeypatch.chdir(tmp_path)
    env = dict(DATASET_NAME="MNIST", DATASET_DIR=str(root.parent), MODEL="textual_prompt",
               VIS_ENCODER="tiny-test", OPTIM_SEED="1", SPLIT_SEED="500", CLIP_CKPT=ckpt,
               ARTIFACT_DIR=str(tmp_path))
    yml = tmp_path / "c.yml"
    yml.write_text("BATCH_SIZE: 8\nEPOCHS: 2\nPREFIX_SIZE: 4\n")
    argv = ["--model_config", str(yml), "--learning_paradigm", "ssl"]
    resp = main_ssl.main(argv, env=env, device="cpu")
    assert 0.0 <= resp[0] <= 1.0
    assert (tmp_path / "trained_prompts" / "MNIST_ssl_textual_prompt_tiny-test_opt_1_spl_500.pickle").exists()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main_ssl.main(argv, env=env)


@pytest.mark.parametrize(
    "model, match",
    [("iterative_visual_fpl", "IFPL/GRIP slice"), ("multimodal_prompt", "UPT slice"),
     ("grip_textual", "IFPL/GRIP slice"), ("iterative_textual_fpl", "IFPL/GRIP slice")],
)
def test_training_models_of_later_slices_raise_naming_them(model, match):
    """The MODELs that `match` named as a later slice run now: check_model
    accepts them and run_strategy hands each to its training method."""
    common.check_model(model)
    modality, method = common.MODEL_DISPATCH[model]
    calls = []

    class Recorder:
        def __getattr__(self, name):
            return lambda *a, **k: calls.append(name) or (0.0, [])

    assert common.run_strategy(Recorder(), method, None, None, None) == (0.0, [])
    assert calls == [method]
    assert callable(getattr(strategy_class(modality), method))
    assert getattr(TrainingStrategy, method) is getattr(strategy_class(modality), method)
