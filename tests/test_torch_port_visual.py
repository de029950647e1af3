"""The port's VPT slice against the JAX package, on the CPU, at the tiny-test
width: the prefix insert, the vision tower with and without deep prompts,
their gradients, four SGD steps of `VisualStrategy`, its prompt init and
memo, the image-modality artifacts, and the early refusal of sequences the
attention-backward kernel does not take.

Weights cross between the packages through `from_jax_params`, or one
OpenAI-layout .pt that both `load_clip`s read.  The initial prompt is the JAX
package's jax.random draw, carried across (the port draws from a
torch.Generator, which cannot reproduce it).

Tolerances: features 2e-4 (fp32, as the model parity tests); gradients 1e-5;
loss (relative), correct count and updated prompts after a step 1e-5 (the
JAX side differentiates XLA attention, the port its plain backward, equal to
rounding).
"""

import dataclasses
import os
import pickle
from types import SimpleNamespace

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
    vision_tokens_with_prefix as jax_vision_tokens_with_prefix,
    vpt_image_features as jax_vpt_image_features,
)
from menghini_neurips23_tpu.runtime import ClipRuntime as JaxClipRuntime
from menghini_neurips23_tpu.training import VisualStrategy as JaxVisualStrategy
from menghini_neurips23_tpu_torch.config import Config
from menghini_neurips23_tpu_torch.evaluation import persist
from menghini_neurips23_tpu_torch.models import TINY_TEST, VIT_B32, VIT_L14, build_clip, from_jax_params
from menghini_neurips23_tpu_torch.models.prompts import (
    init_deep_prefix,
    init_prefix,
    vision_tokens_with_prefix,
    vpt_image_features,
)
from menghini_neurips23_tpu_torch.ops.attention import attention_bwd, fused_attention
from menghini_neurips23_tpu_torch.runtime import ClipRuntime
from menghini_neurips23_tpu_torch.training import VisualFPL, VisualPrompt, VisualStrategy, strategy_class
from tests.test_torch_parity import _make_state_dict
from tests.torch_port_fixtures import (  # noqa: F401
    L14_GRID,
    l14_grid_runtimes,
    native_build_outside_checkout,
)

torch.set_num_threads(2)

CLASSES = ["0", "1", "2"]
# three vision layers: deep prompts replace the slots before layers 1 and 2
JAX_ARCH3 = dataclasses.replace(JAX_TINY, vision_layers=3)
ARCH3 = dataclasses.replace(TINY_TEST, vision_layers=3)


@pytest.fixture(scope="module")
def towers():
    """(JAX model, its params, the port's CLIP) on the same 3-layer weights."""
    model, params = jax_init_clip_params(JAX_ARCH3, seed=0)
    params = jax.tree.map(np.asarray, params)
    return model, params, build_clip(ARCH3, from_jax_params(params))


@pytest.fixture(scope="module")
def runtimes(tmp_path_factory):
    sd = _make_state_dict(JAX_TINY, np.random.default_rng(16))
    path = tmp_path_factory.mktemp("ckpt") / "tiny_openai.pt"
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, path)
    jax_rt = JaxClipRuntime(JaxConfig(VIS_ENCODER="tiny-test", BATCH_SIZE=8, CLIP_CKPT=str(path)))
    port_rt = ClipRuntime(Config(VIS_ENCODER="tiny-test", BATCH_SIZE=8, CLIP_CKPT=str(path)),
                          device="cpu")
    return jax_rt, port_rt


def _inputs(seed: int, batch: int, arch, deep: bool, prefix_len: int = 4):
    rng = np.random.default_rng(seed)
    W = arch.vision_width
    tokens = rng.normal(0, 1, (batch, 1 + arch.num_patches, W)).astype(np.float32)
    prefix = rng.normal(0, 0.02, (prefix_len, W)).astype(np.float32)
    dp = rng.normal(0, 0.02, (arch.vision_layers - 1, prefix_len, W)).astype(np.float32) if deep else None
    return tokens, prefix, dp


# ------------------------------------------------------------------ prompts
def test_vision_tokens_with_prefix_matches_jax():
    tokens, prefix, _ = _inputs(0, 3, ARCH3, False)
    got = vision_tokens_with_prefix(torch.from_numpy(tokens), torch.from_numpy(prefix))
    want = np.asarray(jax_vision_tokens_with_prefix(jnp.asarray(tokens), jnp.asarray(prefix)))
    assert got.shape == (3, 1 + 4 + ARCH3.num_patches, ARCH3.vision_width)
    np.testing.assert_array_equal(got.numpy(), want)
    # bf16 tokens take the prefix rounded to bf16
    got16 = vision_tokens_with_prefix(torch.from_numpy(tokens).bfloat16(), torch.from_numpy(prefix))
    assert got16.dtype == torch.bfloat16
    torch.testing.assert_close(got16[:, 1:5].float(), torch.from_numpy(prefix).bfloat16().float()
                               .expand(3, -1, -1), rtol=0, atol=0)


@pytest.mark.parametrize("deep", [False, True], ids=["shallow", "deep"])
def test_vision_encode_tokens_matches_jax(towers, deep):
    model, params, port = towers
    tokens, prefix, dp = _inputs(1, 5, ARCH3, deep)
    x = np.asarray(jax_vision_tokens_with_prefix(jnp.asarray(tokens), jnp.asarray(prefix)))
    want = np.asarray(model.apply(params, jnp.asarray(x), None if dp is None else jnp.asarray(dp),
                                  method="vision_encode_tokens"))
    x = np.array(x)
    with torch.no_grad():
        got = port.vision_encode_tokens(torch.from_numpy(x),
                                        None if dp is None else torch.from_numpy(dp))
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)
    # the deep prompts change what comes out; a shorter set (D=1 of the 2
    # layers after the first) replaces the slots before layer 1 only
    if deep:
        with torch.no_grad():
            shallow = port.vision_encode_tokens(torch.from_numpy(x))
        assert not torch.allclose(shallow, got, atol=1e-4)
        one = dp[:1]
        want1 = np.asarray(model.apply(params, jnp.asarray(x), jnp.asarray(one),
                                       method="vision_encode_tokens"))
        with torch.no_grad():
            got1 = port.vision_encode_tokens(torch.from_numpy(x), torch.from_numpy(one))
        np.testing.assert_allclose(got1.numpy(), want1, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("deep", [False, True], ids=["shallow", "deep"])
def test_vpt_prompt_gradient_matches_jax(towers, deep):
    """The gradient of a weighted mean of the image features reaches the
    prefix and the deep prompts, as `jax.grad` computes it; the frozen CLIP
    and the cached tokens gather none."""
    model, params, port = towers
    tokens, prefix, dp = _inputs(2, 4, ARCH3, deep)
    w = np.random.default_rng(3).normal(0, 1, (4, ARCH3.embed_dim)).astype(np.float32)
    tree = {"prefix": jnp.asarray(prefix)}
    if deep:
        tree["deep"] = jnp.asarray(dp)

    def f(t):
        feats = jax_vpt_image_features(model, params, t["prefix"], tokens=jnp.asarray(tokens),
                                       deep_prompts=t.get("deep"))
        return (feats * jnp.asarray(w)).mean()

    want = jax.grad(jax.jit(f))(tree)
    p = torch.from_numpy(prefix.copy()).requires_grad_(True)
    d = torch.from_numpy(dp.copy()).requires_grad_(True) if deep else None
    toks = torch.from_numpy(tokens)
    feats = vpt_image_features(port, p, tokens=toks, deep_prompts=d)
    (feats * torch.from_numpy(w)).mean().backward()
    np.testing.assert_allclose(p.grad.numpy(), np.asarray(want["prefix"]), rtol=1e-5, atol=1e-5)
    if deep:
        np.testing.assert_allclose(d.grad.numpy(), np.asarray(want["deep"]), rtol=1e-5, atol=1e-5)
        assert d.grad.abs().min() > 0  # every deep slot of every layer is used
    assert toks.grad is None and all(q.grad is None for q in port.parameters())


@pytest.mark.parametrize("init", ["normal", "uniform"])
def test_init_deep_prefix_draws_from_the_generator(init):
    a = init_deep_prefix(torch.Generator().manual_seed(1000), 11, 16, 32, init, 0.0, 0.02)
    b = init_deep_prefix(torch.Generator().manual_seed(1000), 11, 16, 32, init, 0.0, 0.02)
    assert a.shape == (11, 16, 32) and a.dtype == torch.float32
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    # one generator: the same numbers as a prefix draw of depth * length rows
    flat = init_prefix(torch.Generator().manual_seed(1000), 11 * 16, 32, init, 0.0, 0.02)
    torch.testing.assert_close(a.reshape(-1, 32), flat, rtol=0, atol=0)
    with pytest.raises(ValueError, match="Unknown prefix init"):
        init_deep_prefix(torch.Generator(), 1, 2, 2, "zeros")


# ---------------------------------------------------------------- strategy
def _config(tmp_path, **kw):
    base = dict(VIS_ENCODER="tiny-test", MODEL="visual_fpl", PREFIX_SIZE=4, BATCH_SIZE=8,
                OPTIM_SEED=1, ARTIFACT_DIR=str(tmp_path))
    base.update(kw)
    return base


def _strategies(runtimes, tmp_path, **kw):
    jax_rt, port_rt = runtimes
    base = _config(tmp_path, **kw)
    l2i = {c: i for i, c in enumerate(CLASSES)}
    jstrat = JaxVisualStrategy(JaxConfig(**base), l2i, CLASSES, CLASSES, CLASSES, runtime=jax_rt)
    pstrat = VisualStrategy(Config(**base), l2i, CLASSES, CLASSES, CLASSES, runtime=port_rt)
    # the same starting prompt: the JAX package's draw
    pstrat.load_parameters([np.asarray(p) for p in jstrat.epoch_parameters()])
    return jstrat, pstrat


@pytest.mark.parametrize("deep", [False, True], ids=["shallow", "deep"])
def test_visual_strategy_prompt_init(runtimes, tmp_path, deep):
    """prefix then deep, from one generator seeded OPTIM_SEED * 1000 + reinit;
    fp32 leaves that require grad; the aliases and the modality table."""
    _, port_rt = runtimes
    cfg = Config(**_config(tmp_path, VPT_DEEP=deep, VIS_PREFIX_INIT="normal"))
    strat = VisualStrategy(cfg, {c: i for i, c in enumerate(CLASSES)}, CLASSES, CLASSES, CLASSES,
                           runtime=port_rt)
    gen = torch.Generator().manual_seed(1000)
    want = [init_prefix(gen, 4, TINY_TEST.vision_width)]
    if deep:
        want.append(init_deep_prefix(gen, TINY_TEST.vision_layers - 1, 4, TINY_TEST.vision_width))
    got = strat.epoch_parameters()
    assert len(got) == len(want) == (2 if deep else 1)
    for g, w in zip(got, want):
        assert g.dtype == np.float32
        np.testing.assert_array_equal(g, w.numpy())
    assert all(p.requires_grad and p.is_leaf and p.dtype == torch.float32
               for p in strat._prompt_params())
    assert strat.prefix is strat.prompt["prefix"]
    assert VisualPrompt is VisualFPL is VisualStrategy is strategy_class("image")


@pytest.mark.parametrize("deep", [False, True], ids=["shallow", "deep"])
@pytest.mark.parametrize("momentum", [0.0, 0.9], ids=["sgd", "momentum"])
@pytest.mark.parametrize("accum", [1, 2], ids=["accum1", "accum2"])
def test_vpt_train_step_matches_jax(runtimes, tmp_path, accum, momentum, deep):
    """Four batches of cached tokens through the port's step and the JAX
    package's `_make_step`: loss, correct count and prompts after every step."""
    jstrat, pstrat = _strategies(runtimes, tmp_path, ACCUMULATION_ITER=accum, MOMENTUM=momentum,
                                 DECAY=0.1, VPT_DEEP=deep)
    for s in (jstrat, pstrat):
        s._w0, s._w1 = 2.0, 1.0
    ctx = np.asarray(jstrat._train_text_class_ids(CLASSES))
    np.testing.assert_allclose(pstrat._train_text_class_ids(CLASSES), ctx, rtol=2e-4, atol=2e-4)
    assert pstrat._class_context(CLASSES).dtype == torch.float32
    step = jstrat._make_step(len(CLASSES))
    jstrat._init_opt_state()
    pstrat._init_opt_state()
    start = pstrat.epoch_parameters()
    rng = np.random.default_rng(5)
    n_tok = 1 + TINY_TEST.num_patches
    for i in range(4):
        toks = rng.normal(0, 1, (8, n_tok, TINY_TEST.vision_width)).astype(np.float32)
        labels = rng.integers(0, 3, 8).astype(np.int32)
        group = rng.integers(0, 2, 8).astype(np.int32)
        valid = np.ones(8, np.float32)
        if i == 3:  # a padded last batch
            labels[5:], valid[5:] = -1, 0.0
        lr = 0.05 * (i + 1)
        apply = (i + 1) % accum == 0
        want = jstrat._apply_step(step, ctx, lr, toks, labels, group, valid, apply=apply)
        got = pstrat._apply_step(
            torch.from_numpy(ctx), lr, torch.from_numpy(toks), torch.from_numpy(labels),
            torch.from_numpy(group), torch.from_numpy(valid), apply=apply,
        )
        np.testing.assert_allclose(got[0], want[0], rtol=1e-5, atol=1e-7)
        assert got[1] == want[1]
        for g, w in zip(pstrat.epoch_parameters(), jstrat.epoch_parameters()):
            np.testing.assert_allclose(g, np.asarray(w), rtol=1e-5, atol=1e-5)
    assert len(pstrat.epoch_parameters()) == (2 if deep else 1)
    assert all(not np.allclose(g, s) for g, s in zip(pstrat.epoch_parameters(), start))
    # the frozen CLIP gathers no gradient; only the prompt leaves have one
    assert all(p.grad is None for p in pstrat.runtime.model.parameters())


def test_vpt_step_above_128_tokens_matches_jax(l14_grid_runtimes, tmp_path):
    """ViT-L/14's patch grid with its 16-token prefix and deep prompts: the
    273-token sequence that K2 tiles on the card, two batches through the
    port's step (its plain backward here) and the JAX package's
    `_make_step`: loss, correct count and prompts after every step."""
    jstrat, pstrat = _strategies(l14_grid_runtimes, tmp_path, VIS_ENCODER=L14_GRID,
                                 PREFIX_SIZE=16, MOMENTUM=0.9, DECAY=0.1, VPT_DEEP=True)
    arch = pstrat.runtime.arch
    assert 1 + arch.num_patches + 16 == 273
    for s in (jstrat, pstrat):
        s._w0, s._w1 = 2.0, 1.0
    ctx = np.asarray(jstrat._train_text_class_ids(CLASSES))
    step = jstrat._make_step(len(CLASSES))
    jstrat._init_opt_state()
    pstrat._init_opt_state()
    start = pstrat.epoch_parameters()
    rng = np.random.default_rng(6)
    for i in range(2):
        toks = rng.normal(0, 1, (8, 1 + arch.num_patches, arch.vision_width)).astype(np.float32)
        labels = rng.integers(0, 3, 8).astype(np.int32)
        group = rng.integers(0, 2, 8).astype(np.int32)
        valid = np.ones(8, np.float32)
        want = jstrat._apply_step(step, ctx, 0.1, toks, labels, group, valid, apply=True)
        got = pstrat._apply_step(
            torch.from_numpy(ctx), 0.1, torch.from_numpy(toks), torch.from_numpy(labels),
            torch.from_numpy(group), torch.from_numpy(valid), apply=True,
        )
        np.testing.assert_allclose(got[0], want[0], rtol=1e-5, atol=1e-7)
        assert got[1] == want[1]
        for g, w in zip(pstrat.epoch_parameters(), jstrat.epoch_parameters()):
            np.testing.assert_allclose(g, np.asarray(w), rtol=1e-5, atol=1e-5)
    assert [g.shape for g in pstrat.epoch_parameters()] == [(16, 32), (1, 16, 32)]
    assert all(not np.allclose(g, s) for g, s in zip(pstrat.epoch_parameters(), start))


def test_prompted_feature_memo_follows_every_prompt_change(runtimes, tmp_path, mnist_fixture):
    """The optimizer updates the prompt in place: every applied step, and
    every load, must make the next `image_features` call recompute."""
    root, _ = mnist_fixture
    _, port_rt = runtimes
    cfg = Config(**_config(tmp_path, ACCUMULATION_ITER=2, VPT_DEEP=True))
    strat = VisualStrategy(cfg, {c: i for i, c in enumerate(CLASSES)}, CLASSES, CLASSES, CLASSES,
                           runtime=port_rt)
    paths = [str(root / "test" / c / f"{c}_img{i}.png") for c in CLASSES for i in range(2)]
    first = strat.image_features(paths)
    assert first.shape == (6, TINY_TEST.embed_dim)
    np.testing.assert_allclose(np.linalg.norm(first, axis=1), 1.0, rtol=1e-5)
    assert strat.image_features(paths) is first  # memo hit
    ctx = strat._class_context(CLASSES)
    toks = torch.from_numpy(np.asarray(strat._features_for_paths(paths), np.float32))
    batch = (torch.tensor([0, 0, 1, 1, 2, 2], dtype=torch.int32), torch.zeros(6, dtype=torch.int32),
             torch.ones(6))
    strat._apply_step(ctx, 0.5, toks, *batch, apply=False)  # accumulates only
    assert strat.image_features(paths) is first
    strat._apply_step(ctx, 0.5, toks, *batch, apply=True)  # in-place SGD update
    second = strat.image_features(paths)
    assert second is not first and not np.allclose(second, first, atol=1e-6)
    params = strat.epoch_parameters()
    strat.load_parameters([np.zeros_like(p) for p in params])
    third = strat.image_features(paths)
    assert not np.allclose(third, second, atol=1e-6)
    strat.load_parameters(params)
    np.testing.assert_allclose(strat.image_features(paths), second, rtol=1e-6, atol=1e-6)
    # a user transform becoming active clears the memo (it was keyed before)
    strat._note_transform(SimpleNamespace(transform=lambda img: img))
    assert strat._img_feats_memo is None


# ------------------------------------------------------------------ persist
@pytest.mark.parametrize("deep", [False, True], ids=["shallow", "deep"])
@pytest.mark.parametrize("fmt", ["numpy", "torch"])
def test_visual_prompt_artifact_matches_jax_and_round_trips(runtimes, tmp_path, fmt, deep):
    jstrat, pstrat = _strategies(runtimes, tmp_path, ARTIFACT_FORMAT=fmt, VPT_DEEP=deep)
    params = pstrat.epoch_parameters()
    kw = dict(VIS_ENCODER="tiny-test", MODEL="visual_fpl", ARTIFACT_FORMAT=fmt)
    jcfg = JaxConfig(ARTIFACT_DIR=str(tmp_path / "jax"), **kw)
    pcfg = Config(ARTIFACT_DIR=str(tmp_path / "port"), **kw)
    assert pcfg.MODALITY == jcfg.MODALITY == "image"
    jax_persist.save_parameters(params, jcfg)
    persist.save_parameters(params, pcfg)
    rel = "trained_prompts/_ssl_visual_fpl_tiny-test_opt_1_spl_500.pickle"
    assert os.path.relpath(persist._prompt_file_name(pcfg), pcfg.ARTIFACT_DIR) == rel
    with open(tmp_path / "port" / rel, "rb") as f:
        got = pickle.load(f)
    with open(tmp_path / "jax" / rel, "rb") as f:
        want = pickle.load(f)
    assert type(got) is type(want) and len(got) == len(want) == len(params) == (2 if deep else 1)
    W = TINY_TEST.vision_width
    shapes = [(4, W)] + ([(TINY_TEST.vision_layers - 1, 4, W)] if deep else [])
    for g, w, shape in zip(got, want, shapes):
        assert type(g) is type(w)
        if fmt == "torch":
            assert isinstance(g, torch.Tensor)
        assert tuple(g.shape) == shape  # the visual prefix stays unbatched
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
    # each package reads the other's artifact back into the same prompt
    pstrat.config.ARTIFACT_DIR = str(tmp_path / "jax")
    pstrat.config.ARTIFACT_FORMAT = fmt
    pstrat.load_parameters([np.zeros_like(p) for p in params])
    pstrat.load_model_eval()
    for g, p in zip(pstrat.epoch_parameters(), params):
        np.testing.assert_array_equal(g, p)
    jcfg.ARTIFACT_DIR = str(tmp_path / "port")
    jstrat.config = jcfg
    jstrat.load_model_eval()
    for g, p in zip(jstrat.epoch_parameters(), params):
        np.testing.assert_array_equal(np.asarray(g), p)
    # a reference-produced batched (1, L, W) prefix loads as (L, W)
    pstrat.load_parameters([params[0][None]] + params[1:])
    np.testing.assert_array_equal(pstrat.epoch_parameters()[0], params[0])


# ------------------------------------------------ long prompted sequences
def _stub_runtime(arch, device):
    return SimpleNamespace(arch=arch, device=torch.device(device))


def fake_cuda_tensors(monkeypatch):
    """A card for building a strategy on this CPU-only torch: CUDA reports
    itself available, and a tensor or module asked for on a CUDA device is
    made on the meta device instead (shape and type, no data).  Returns the
    devices asked for, in order."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    asked, real_tensor, real_to_empty = [], torch.tensor, torch.nn.Module.to_empty

    def meta_for_cuda(device):
        if device is not None and torch.device(device).type == "cuda":
            asked.append(torch.device(device))
            return "meta"
        return device

    def tensor(data, *args, device=None, **kwargs):
        return real_tensor(data, *args, device=meta_for_cuda(device), **kwargs)

    def to_empty(module, *, device, **kwargs):
        return real_to_empty(module, device=meta_for_cuda(device), **kwargs)

    monkeypatch.setattr(torch, "tensor", tensor)
    monkeypatch.setattr(torch.nn.Module, "to_empty", to_empty)
    return asked


@pytest.mark.parametrize("arch, prefix", [(VIT_L14, 80), (VIT_L14, 16), (VIT_B32, 80),
                                          (VIT_B32, 271)],
                         ids=["ViT-L/14-L80", "ViT-L/14", "ViT-B/32-L80", "ViT-B/32-L271"])
def test_vpt_builds_on_cuda_at_any_sequence_length(monkeypatch, arch, prefix):
    """On CUDA (faked here) VPT builds at every prompted sequence length:
    ViT-L/14 with an 80-token prompt (T = 1 + 256 + 80 = 337, past the 320
    tokens K and V stay resident in shared memory, so both kernels stream
    them) and with the bundled 16 (T = 273); ViT-B/32 with 80 (T = 130) and
    271 (T = 321).  The prompt is drawn on the card's device and nothing is
    launched while building."""
    asked = fake_cuda_tensors(monkeypatch)
    T = 1 + arch.num_patches + prefix
    assert T in (337, 273, 130, 321)
    cfg = Config(VIS_ENCODER=arch.name, MODEL="visual_fpl", PREFIX_SIZE=prefix)
    launches = (fused_attention.launches, attention_bwd.launches)
    strat = VisualStrategy(cfg, {"0": 0}, ["0"], ["0"], ["0"], runtime=_stub_runtime(arch, "cuda"))
    assert strat.prefix.shape == (prefix, arch.vision_width)
    assert strat.prefix.device.type == "meta" and strat.prefix.requires_grad
    assert asked and all(d.type == "cuda" for d in asked)
    assert (fused_attention.launches, attention_bwd.launches) == launches
