"""The port's UPT slice against the JAX package, on the CPU: the mixer and
its gradients, four `multimodal_fpl` steps, the prompt init, the logits
memo, the 8-part artifacts in both formats, whole `multimodal_prompt` and
`multimodal_fpl` workflows through the three runners, and the early
refusal of vision sequences the attention-backward kernel does not take.

Weights cross between the packages through `from_jax_params`, or one
OpenAI-layout .pt that both `load_clip`s read.  The initial UPT prompt is
the JAX package's draw (jax.random prompts and flax's mixer initializers),
carried across with `upt_from_jax_params`: no torch generator reproduces it.

Tolerances: the mixer's forward 2e-5 and its gradients 1e-5 (fp32, sums in
another order; with UPT_FP16_QUIRK the fp16 rounding is exact where no value
lies within the fp32 difference of a rounding midpoint, which the test
asserts first); after a step the loss (relative) and every parameter 1e-5;
workflows as in tests/test_torch_port_paradigms.py (prompts 1e-4, logits
2e-4, everything else exact).
"""

import json
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from menghini_neurips23_tpu.config import Config as JaxConfig
from menghini_neurips23_tpu.evaluation import persist as jax_persist
from menghini_neurips23_tpu.models import TINY_TEST as JAX_TINY
from menghini_neurips23_tpu.models.prompts import UPTMixer as JaxUPTMixer
from menghini_neurips23_tpu.models.prompts import init_upt_params as jax_init_upt_params
from menghini_neurips23_tpu.models.prompts import upt_features as jax_upt_features
from menghini_neurips23_tpu.runners import common as jax_common
from menghini_neurips23_tpu.training import MultimodalStrategy as JaxMultimodalStrategy
from menghini_neurips23_tpu_torch.config import Config
from menghini_neurips23_tpu_torch.evaluation import persist
from menghini_neurips23_tpu_torch.models import (
    TINY_TEST,
    VIT_B32,
    VIT_L14,
    build_clip,
    from_jax_params,
    init_clip_params,
)
from menghini_neurips23_tpu_torch.models.prompts import (
    UPTMixer,
    build_upt_mixer,
    init_prefix,
    init_upt_params,
    mixer_attention,
    mixer_parts,
    upt_features,
    upt_from_jax_params,
)
from menghini_neurips23_tpu_torch.ops.attention import attention_bwd, fused_attention
from menghini_neurips23_tpu_torch.runners import common
from menghini_neurips23_tpu_torch.training import (
    MultimodalFPL,
    MultimodalPrompt,
    MultimodalStrategy,
    strategy_class,
)
from menghini_neurips23_tpu_torch.training import multimodal as port_multimodal
from tests.test_torch_port_paradigms import RUNNERS, _listing, _load, _margins, ckpt, runtimes  # noqa: F401
from tests.torch_port_fixtures import (  # noqa: F401
    L14_GRID,
    l14_grid_runtimes,
    native_build_outside_checkout,
)

torch.set_num_threads(2)

CLASSES = ["0", "1", "2"]


def _jax_upt_tree(seed, cfg, arch):
    return jax.tree.map(np.asarray, jax_init_upt_params(jax.random.PRNGKey(seed), cfg, arch))


def _jax_upt_draws(monkeypatch):
    """Make the port's UPT init return the JAX package's draw for the same
    key (OPTIM_SEED * 1000 + reinit)."""
    monkeypatch.setattr(
        port_multimodal, "init_upt_params",
        lambda gen, cfg, arch: upt_from_jax_params(_jax_upt_tree(gen.initial_seed(), cfg, arch)),
    )


def _leaves_close(got, want, tol):
    """Two trees of the same structure (flax-layout dicts, lists, None)."""
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), rtol=tol, atol=tol)


# ------------------------------------------------------------------ mixer
def _mixer_grads_close(mixer, jgrads, arch, cfg, tol):
    grads = build_upt_mixer(arch, cfg, {n: p.grad for n, p in mixer.named_parameters()}, "cpu")
    names = ["transformer", "proj_coop_pre", "proj_coop_post", "proj_vpt_pre", "proj_vpt_post"]
    for name, part in zip(names, mixer_parts(grads)):
        _leaves_close(part, jax.tree.map(np.asarray, jgrads[name]), tol)


def test_upt_mixer_and_its_gradients_match_jax():
    """The whole mixer in fp32 at ViT-B/32 widths (coop 512, vpt 768, mixer
    128, L = 4): the two mixed prompts, and the gradients of a weighted
    mean of them in the prompts and in every mixer parameter."""
    a = VIT_B32
    cfg = Config(TRANSFORMER_DIM=128)
    tree = _jax_upt_tree(5, cfg, a)
    jm = JaxUPTMixer(a.transformer_width, a.vision_width, 128)
    prompt = upt_from_jax_params(tree)
    mixer = build_upt_mixer(a, cfg, prompt["mixer"], "cpu")
    assert isinstance(mixer, UPTMixer) and not mixer.fp16_quirk
    want = jm.apply(tree["mixer"], tree["coop"], tree["vpt"])
    coop = prompt["coop"].clone().requires_grad_(True)
    vpt = prompt["vpt"].clone().requires_grad_(True)
    got = mixer(coop, vpt)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == torch.float32
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), rtol=2e-5, atol=2e-5)

    rng = np.random.default_rng(6)
    wc = rng.normal(0, 1, want[0].shape).astype(np.float32)
    wv = rng.normal(0, 1, want[1].shape).astype(np.float32)

    def f(t):
        c, v = jm.apply(t["mixer"], t["coop"], t["vpt"])
        return (c * wc).mean() + (v * wv).mean()

    jg = jax.grad(f)({k: tree[k] for k in ("coop", "vpt", "mixer")})
    ((got[0] * torch.from_numpy(wc)).mean() + (got[1] * torch.from_numpy(wv)).mean()).backward()
    np.testing.assert_allclose(coop.grad.numpy(), np.asarray(jg["coop"]), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(vpt.grad.numpy(), np.asarray(jg["vpt"]), rtol=1e-5, atol=1e-5)
    _mixer_grads_close(mixer, jg["mixer"]["params"], a, cfg, 1e-5)


def test_upt_mixer_fp16_quirk_matches_jax():
    """UPT_FP16_QUIRK rounds the transformer's output through fp16 before the
    back-projections, as the JAX mixer does (and the reference UPTModel).
    Rounding is discontinuous: at ViT-B/32 widths some of the 1,024 outputs
    lie closer to an fp16 midpoint than the two packages' fp32 transformers
    differ (the fp32 test holds those to 2e-5), so the rounded stage is
    held to the JAX mixer's own code on one shared input: the forward within
    2e-5 and the gradients (the fp16-rounded cotangent included) within
    1e-5.  The whole quirk mixer is that stage after the fp32 transformer,
    exactly."""
    import flax.linen as fnn

    a = VIT_B32
    cfg = Config(TRANSFORMER_DIM=128, UPT_FP16_QUIRK=True)
    tree = _jax_upt_tree(5, cfg, a)
    mp = tree["mixer"]["params"]
    prompt = upt_from_jax_params(tree)
    mixer = build_upt_mixer(a, cfg, prompt["mixer"], "cpu")
    assert mixer.fp16_quirk
    with torch.no_grad():
        pre = torch.stack([mixer.proj_coop_pre(prompt["coop"]),
                           mixer.proj_vpt_pre(prompt["vpt"])], dim=1)
        whole = mixer(prompt["coop"], prompt["vpt"])
        staged = mixer.project_back(mixer.transformer(pre))
    for w, s in zip(whole, staged):
        torch.testing.assert_close(w, s, rtol=0, atol=0)
    # JAX: the quirk lines of its UPTMixer.__call__, with its Dense layers
    t = np.random.default_rng(7).normal(0, 1.5, (4, 2, 128)).astype(np.float32)
    rng = np.random.default_rng(8)
    wc = rng.normal(0, 1, (4, a.transformer_width)).astype(np.float32)
    wv = rng.normal(0, 1, (4, a.vision_width)).astype(np.float32)

    def jax_stage(t, post_c, post_v):
        out = t.astype(jnp.float16).astype(jnp.float32)
        c = fnn.Dense(a.transformer_width).apply({"params": post_c}, out[:, 0, :])
        v = fnn.Dense(a.vision_width).apply({"params": post_v}, out[:, 1, :])
        return c, v

    def f(t, post_c, post_v):
        c, v = jax_stage(t, post_c, post_v)
        return (c * wc).mean() + (v * wv).mean()

    want = jax_stage(jnp.asarray(t), mp["proj_coop_post"], mp["proj_vpt_post"])
    jg = jax.grad(f, argnums=(0, 1, 2))(jnp.asarray(t), mp["proj_coop_post"], mp["proj_vpt_post"])
    tt = torch.from_numpy(t).requires_grad_(True)
    got = mixer.project_back(tt)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), rtol=2e-5, atol=2e-5)
    ((got[0] * torch.from_numpy(wc)).mean() + (got[1] * torch.from_numpy(wv)).mean()).backward()
    np.testing.assert_allclose(tt.grad.numpy(), np.asarray(jg[0]), rtol=1e-5, atol=1e-5)
    for lin, jd in ((mixer.proj_coop_post, jg[1]), (mixer.proj_vpt_post, jg[2])):
        np.testing.assert_allclose(lin.weight.grad.numpy().T, np.asarray(jd["kernel"]),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(lin.bias.grad.numpy(), np.asarray(jd["bias"]), rtol=1e-5,
                                   atol=1e-5)
    # the round-trip changed something: the quirk is on
    plain = build_upt_mixer(a, Config(TRANSFORMER_DIM=128), prompt["mixer"], "cpu")
    with torch.no_grad():
        assert not torch.equal(plain.project_back(torch.from_numpy(t))[0], got[0])


def test_mixer_attention_is_plain_and_the_towers_keep_the_kernels():
    """The mixer's 128-wide single head runs plain fp32 attention on every
    device, by design; the CLIP towers' layers keep `fused_attention`."""
    mixer = UPTMixer(32, 48, 128)
    assert all(b.attn.attention is mixer_attention for b in mixer.transformer.resblocks)
    clip = build_clip(TINY_TEST, init_clip_params(TINY_TEST, seed=0))
    for tower in (clip.visual, clip.text):
        assert all(b.attn.attention is fused_attention for b in tower.transformer.resblocks)
    qkv = torch.randn(4, 2, 3 * 128, dtype=torch.float64)
    out = mixer_attention(qkv, None, 1)
    assert out.dtype == torch.float32 and out.shape == (4, 2, 128)


@pytest.mark.parametrize("deep", [False, True], ids=["shallow", "deep"])
def test_upt_features_match_jax(deep):
    """Both prompted towers through the mixed prompts, on the same weights."""
    from menghini_neurips23_tpu.models import init_clip_params as jax_init_clip_params

    model, params = jax_init_clip_params(JAX_TINY, seed=0)
    params = jax.tree.map(np.asarray, params)
    port = build_clip(TINY_TEST, from_jax_params(params))
    cfg = Config(TRANSFORMER_DIM=128, VPT_DEEP=deep)
    tree = _jax_upt_tree(3, cfg, TINY_TEST)
    jm = JaxUPTMixer(JAX_TINY.transformer_width, JAX_TINY.vision_width, 128)
    rng = np.random.default_rng(4)
    tokens = rng.normal(0, 1, (5, 1 + TINY_TEST.num_patches, TINY_TEST.vision_width)).astype(
        np.float32)
    ids = np.zeros((3, 77), np.int64)
    ids[:, 0] = TINY_TEST.vocab_size - 2
    ids[:, 1:9] = rng.integers(1, 400, (3, 8))
    ids[np.arange(3), [9, 10, 11]] = TINY_TEST.vocab_size - 1
    jt, ji = jax_upt_features(model, params, jm, tree, jnp.asarray(ids.astype(np.int32)),
                              tokens=jnp.asarray(tokens))
    prompt = upt_from_jax_params(tree)
    mixer = build_upt_mixer(TINY_TEST, cfg, prompt["mixer"], "cpu")
    with torch.no_grad():
        pt, pi = upt_features(port, mixer, prompt, torch.from_numpy(ids),
                              tokens=torch.from_numpy(tokens))
    np.testing.assert_allclose(pt.numpy(), np.asarray(jt), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(pi.numpy(), np.asarray(ji), rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("deep", [False, True], ids=["shallow", "deep"])
def test_upt_init_draws_from_the_generator(deep):
    """coop, vpt, the mixer, then deep from one generator; shapes, fp32, the
    flax initializers' distributions; unequal prompt lengths raise."""
    cfg = Config(TRANSFORMER_DIM=128, VPT_DEEP=deep)
    a = init_upt_params(torch.Generator().manual_seed(1000), cfg, VIT_B32)
    b = init_upt_params(torch.Generator().manual_seed(1000), cfg, VIT_B32)
    assert set(a) == ({"coop", "vpt", "mixer", "deep"} if deep else {"coop", "vpt", "mixer"})
    gen = torch.Generator().manual_seed(1000)
    torch.testing.assert_close(a["coop"], init_prefix(gen, 4, 512), rtol=0, atol=0)
    torch.testing.assert_close(a["vpt"], init_prefix(gen, 4, 768), rtol=0, atol=0)
    for k in a["mixer"]:
        torch.testing.assert_close(a["mixer"][k], b["mixer"][k], rtol=0, atol=0)
    if deep:
        assert a["deep"].shape == (VIT_B32.vision_layers - 1, 4, 768)
    sd = a["mixer"]
    assert sd["proj_coop_pre.weight"].shape == (128, 512)
    assert sd["transformer.resblocks.0.attn.in_proj_weight"].shape == (384, 128)
    assert torch.equal(sd["transformer.resblocks.0.ln_1.weight"], torch.ones(128))
    assert torch.equal(sd["proj_vpt_post.bias"], torch.zeros(768))
    # truncated lecun-normal: std 1/sqrt(fan_in), nothing beyond 2 / 0.8796 of it
    w = sd["proj_coop_pre.weight"]
    assert abs(float(w.std()) * 512**0.5 - 1) < 0.02
    assert float(w.abs().max()) <= 2 / 0.87962566103423978 * 512**-0.5 + 1e-6
    assert abs(float(sd["transformer.resblocks.0.attn.in_proj_weight"].std()) * 128**0.5 - 1) < 0.03
    with pytest.raises(ValueError, match="TEXT_PREFIX_SIZE == VISION_PREFIX_SIZE"):
        init_upt_params(torch.Generator(), Config(TEXT_PREFIX_SIZE=4, VISION_PREFIX_SIZE=8),
                        VIT_B32)


# ---------------------------------------------------------------- strategy
def _base(tmp_path, **kw):
    base = dict(VIS_ENCODER="tiny-test", MODEL="multimodal_fpl", BATCH_SIZE=8, OPTIM_SEED=1,
                TRANSFORMER_DIM=128, ARTIFACT_DIR=str(tmp_path))
    base.update(kw)
    return base


def _strategies(runtimes, tmp_path, **kw):
    jax_rt, port_rt = runtimes
    base = _base(tmp_path, **kw)
    l2i = {c: i for i, c in enumerate(CLASSES)}
    jstrat = JaxMultimodalStrategy(JaxConfig(**base), l2i, CLASSES, CLASSES, CLASSES,
                                   runtime=jax_rt)
    pstrat = MultimodalStrategy(Config(**base), l2i, CLASSES, CLASSES, CLASSES, runtime=port_rt)
    pstrat.load_parameters(jstrat.epoch_parameters())  # the JAX package's draw
    return jstrat, pstrat


@pytest.mark.parametrize("deep", [False, True], ids=["shallow", "deep"])
@pytest.mark.parametrize("momentum", [0.0, 0.9], ids=["sgd", "momentum"])
def test_upt_train_step_matches_jax(runtimes, tmp_path, momentum, deep):
    """Four batches of cached tokens through the port's step and the JAX
    package's `_make_step` (the last one padded, the third accumulated
    only): loss, correct count and every parameter after every step."""
    jstrat, pstrat = _strategies(runtimes, tmp_path, ACCUMULATION_ITER=1, MOMENTUM=momentum,
                                 DECAY=0.1, VPT_DEEP=deep)
    for s in (jstrat, pstrat):
        s._w0, s._w1 = 2.0, 1.0
    ids = np.asarray(jstrat._train_text_class_ids(CLASSES))
    assert ids.shape == (3, 77)  # the full context: TEXT_TRUNCATE is textual-only
    np.testing.assert_array_equal(pstrat._train_text_class_ids(CLASSES), ids)
    ctx = pstrat._class_context(CLASSES)
    assert ctx.dtype == torch.long
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
        if i == 3:
            labels[5:], valid[5:] = -1, 0.0
        lr = 0.05 * (i + 1)
        apply = i != 2
        want = jstrat._apply_step(step, ids, lr, toks, labels, group, valid, apply=apply)
        got = pstrat._apply_step(ctx, lr, torch.from_numpy(toks), torch.from_numpy(labels),
                                 torch.from_numpy(group), torch.from_numpy(valid), apply=apply)
        np.testing.assert_allclose(got[0], want[0], rtol=1e-5, atol=1e-7)
        assert got[1] == want[1]
        got_p, want_p = pstrat.epoch_parameters(), jstrat.epoch_parameters()
        assert (got_p[6] is None) == (want_p[6] is None) == (not deep)
        _leaves_close(got_p, jax.tree.map(np.asarray, want_p), 1e-5)
    moved = [p for p, s in zip(pstrat.epoch_parameters(), start)
             if p is not None and not np.allclose(p if isinstance(p, np.ndarray) else 0,
                                                  s if isinstance(s, np.ndarray) else 0)]
    assert len(moved) == (3 if deep else 2)  # coop, vpt and deep moved
    assert all(p.grad is None for p in pstrat.runtime.model.parameters())


def test_upt_step_above_128_tokens_matches_jax(l14_grid_runtimes, tmp_path):
    """ViT-L/14's patch grid with UPT's 4-token vision prompt: the 261-token
    vision sequence that K2 tiles on the card (and the (3, 77) causal text
    tower), two batches through the port's step and the JAX package's
    `_make_step`: loss, correct count and every parameter after every step."""
    jstrat, pstrat = _strategies(l14_grid_runtimes, tmp_path, VIS_ENCODER=L14_GRID,
                                 MOMENTUM=0.9, DECAY=0.1)
    arch = pstrat.runtime.arch
    assert 1 + arch.num_patches + pstrat.config.VISION_PREFIX_SIZE == 261
    for s in (jstrat, pstrat):
        s._w0, s._w1 = 2.0, 1.0
    ids = np.asarray(jstrat._train_text_class_ids(CLASSES))
    ctx = pstrat._class_context(CLASSES)
    step = jstrat._make_step(len(CLASSES))
    jstrat._init_opt_state()
    pstrat._init_opt_state()
    rng = np.random.default_rng(7)
    for i in range(2):
        toks = rng.normal(0, 1, (8, 1 + arch.num_patches, arch.vision_width)).astype(np.float32)
        labels = rng.integers(0, 3, 8).astype(np.int32)
        group = rng.integers(0, 2, 8).astype(np.int32)
        valid = np.ones(8, np.float32)
        want = jstrat._apply_step(step, ids, 0.1, toks, labels, group, valid, apply=True)
        got = pstrat._apply_step(ctx, 0.1, torch.from_numpy(toks), torch.from_numpy(labels),
                                 torch.from_numpy(group), torch.from_numpy(valid), apply=True)
        np.testing.assert_allclose(got[0], want[0], rtol=1e-5, atol=1e-7)
        assert got[1] == want[1]
        _leaves_close(pstrat.epoch_parameters(), jax.tree.map(np.asarray,
                                                              jstrat.epoch_parameters()), 1e-5)


def test_multimodal_strategy_init_aliases_and_memo(runtimes, tmp_path, mnist_fixture):
    """fp32 leaves that require grad (the mixer's too), the aliases, and a
    logits memo that misses after every applied step and every load."""
    root, _ = mnist_fixture
    _, port_rt = runtimes
    cfg = Config(**_base(tmp_path, VPT_DEEP=True))
    strat = MultimodalStrategy(cfg, {c: i for i, c in enumerate(CLASSES)}, CLASSES, CLASSES,
                               CLASSES, runtime=port_rt)
    want = init_upt_params(torch.Generator().manual_seed(1000), cfg, TINY_TEST)
    params = strat.epoch_parameters()
    np.testing.assert_array_equal(params[5], want["coop"].numpy())
    np.testing.assert_array_equal(params[7], want["vpt"].numpy())
    np.testing.assert_array_equal(params[6], want["deep"].numpy())
    assert all(p.requires_grad and p.is_leaf and p.dtype == torch.float32
               for p in strat._prompt_params())
    assert len(strat._prompt_params()) == 3 + len(list(strat.mixer.parameters()))
    assert MultimodalPrompt is MultimodalFPL is MultimodalStrategy is strategy_class("multi")

    paths = [str(root / "test" / c / f"{c}_img{i}.png") for c in CLASSES for i in range(2)]
    first = strat._predict_logits(paths, CLASSES)
    assert first.shape == (6, 3) and strat._predict_logits(paths, CLASSES) is first
    assert strat._predict_logits(paths, CLASSES[:2]) is not first  # keyed on the classes
    ctx = strat._class_context(CLASSES)
    toks = torch.from_numpy(np.array(strat._features_for_paths(paths), np.float32))
    batch = (torch.tensor([0, 0, 1, 1, 2, 2], dtype=torch.int32),
             torch.zeros(6, dtype=torch.int32), torch.ones(6))
    first = strat._predict_logits(paths, CLASSES)
    strat._apply_step(ctx, 0.5, toks, *batch, apply=True)
    second = strat._predict_logits(paths, CLASSES)
    assert second is not first and not np.allclose(second, first, atol=1e-6)
    strat.load_parameters(params)
    np.testing.assert_allclose(strat._predict_logits(paths, CLASSES), first, rtol=1e-6,
                               atol=1e-6)
    strat._note_transform(SimpleNamespace(transform=lambda img: img))
    assert strat._logits_memo is None


# ------------------------------------------------------------------ persist
@pytest.mark.parametrize("deep", [False, True], ids=["shallow", "deep"])
@pytest.mark.parametrize("fmt", ["numpy", "torch"])
def test_multimodal_artifacts_match_jax_and_round_trip(runtimes, tmp_path, fmt, deep):
    """The 8 parts under the JAX package's names, byte-equal contents in
    both formats, and each package reads the other's back."""
    jstrat, pstrat = _strategies(runtimes, tmp_path, ARTIFACT_FORMAT=fmt, VPT_DEEP=deep)
    params = pstrat.epoch_parameters()
    kw = dict(VIS_ENCODER="tiny-test", MODEL="multimodal_fpl", ARTIFACT_FORMAT=fmt)
    jcfg = JaxConfig(ARTIFACT_DIR=str(tmp_path / "jax"), **kw)
    pcfg = Config(ARTIFACT_DIR=str(tmp_path / "port"), **kw)
    assert pcfg.MODALITY == jcfg.MODALITY == "multi"
    jax_persist.save_parameters(params, jcfg, iteration=2)
    persist.save_parameters(params, pcfg, iteration=2)
    listing = _listing(tmp_path / "port")
    assert listing == _listing(tmp_path / "jax") and len(listing) == 8
    assert persist.MULTI_PART_NAMES == jax_persist.MULTI_PART_NAMES
    for rel in listing:
        if rel.endswith(".pt"):
            got = torch.load(tmp_path / "port" / rel, weights_only=True)
            want = torch.load(tmp_path / "jax" / rel, weights_only=False)
            assert list(got) == list(want)
            for k in got:
                assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k])
        else:
            got, want = _load(tmp_path / "port" / rel), _load(tmp_path / "jax" / rel)
            assert type(got) is type(want)
            if got is not None:
                _leaves_close(got, want, 0)
    if fmt == "torch":  # the reference's batched (1, L, W) embeddings
        coop = [r for r in listing if r.endswith("coop_embeddings.pickle")][0]
        assert _load(tmp_path / "port" / coop).shape == (1, 4, TINY_TEST.transformer_width)
    pcfg.ARTIFACT_DIR = str(tmp_path / "jax")
    _leaves_close(persist.load_saved_parameters(pcfg, iteration=2), params, 0)
    pstrat.config.ARTIFACT_DIR, pstrat.config.ARTIFACT_FORMAT = str(tmp_path / "jax"), fmt
    pstrat.load_parameters(jstrat.epoch_parameters())
    pstrat.load_model_eval(iteration=2)
    _leaves_close(pstrat.epoch_parameters(), params, 0)
    jcfg.ARTIFACT_DIR = str(tmp_path / "port")
    jstrat.config = jcfg
    jstrat.load_model_eval(iteration=2)
    _leaves_close(jax.tree.map(np.asarray, jstrat.epoch_parameters()), params, 0)


# ----------------------------------------------------------------- workflows
def _kw(root, artifact_dir, ckpt, paradigm, model):
    return dict(
        DATASET_NAME="MNIST", DATASET_DIR=str(root.parent), MODEL=model, VIS_ENCODER="tiny-test",
        LEARNING_PARADIGM=paradigm, PROMPT_TEMPLATE="a photo of a {}", BATCH_SIZE=8, EPOCHS=2,
        N_PSEUDOSHOTS=16, LR=0.1, OPTIM_SEED=1, SPLIT_SEED=500, CLIP_CKPT=ckpt,
        TRANSFORMER_DIM=128, ARTIFACT_DIR=str(artifact_dir),
    )


WORKFLOW_CASES = [(p, m) for p in ("ssl", "ul", "trzsl")
                  for m in ("multimodal_prompt", "multimodal_fpl")]


@pytest.mark.parametrize("paradigm, model", WORKFLOW_CASES,
                         ids=[f"{p}-{m}" for p, m in WORKFLOW_CASES])
def test_multimodal_workflow_matches_jax(tmp_path, mnist_fixture, runtimes, ckpt, monkeypatch,
                                         paradigm, model):
    root, _ = mnist_fixture
    jax_rt, port_rt = runtimes
    _jax_upt_draws(monkeypatch)
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
    jcfg = JaxConfig(**_kw(root, tmp_path / "jax", ckpt, paradigm, model))
    pcfg = Config(**_kw(root, tmp_path / "port", ckpt, paradigm, model))
    jresp = jmod.workflow(jcfg.DATASET_DIR, jcfg, runtime=jax_rt)
    presp = pmod.workflow(pcfg.DATASET_DIR, pcfg, runtime=port_rt)

    jstrat, (jbest, jparams) = results["jax"]
    pstrat, (pbest, pparams) = results["port"]
    assert pbest == pytest.approx(jbest, abs=1e-6)
    _leaves_close(pparams, jax.tree.map(np.asarray, jparams), 1e-4)
    assert _listing(tmp_path / "port") == _listing(tmp_path / "jax")
    saved = persist.load_saved_parameters(pcfg)
    _leaves_close(saved, pparams, 0)
    if model.endswith("fpl"):
        caches = [f for f in _listing(tmp_path / "port") if f.startswith("pseudolabels/")]
        assert len(caches) == 1
        assert _load(tmp_path / "port" / caches[0]) == _load(tmp_path / "jax" / caches[0])
        assert pstrat._train_groups == jstrat._train_groups
        assert (pstrat._w0, pstrat._w1) == pytest.approx((jstrat._w0, jstrat._w1))
    stem = f"MNIST_{paradigm}_{model}_tiny-test_opt_1_spl_500.pickle"
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
    np.testing.assert_equal({k: v for k, v in prec.items() if k != "config"},
                            {k: v for k, v in jrec.items() if k != "config"})


# ------------------------------------------------ long prompted sequences
@pytest.mark.parametrize("arch, vision_prefix", [(VIT_L14, 80), (VIT_L14, 4)],
                         ids=["ViT-L/14-L80", "ViT-L/14"])
def test_upt_builds_on_cuda_at_any_sequence_length(monkeypatch, arch, vision_prefix):
    """On CUDA (faked here) UPT builds at ViT-L/14 with an 80-token vision
    prompt (T = 1 + 256 + 80 = 337, which both kernels stream) and with its
    bundled 4 (T = 261); nothing is launched while building."""
    from tests.test_torch_port_visual import fake_cuda_tensors

    asked = fake_cuda_tensors(monkeypatch)
    cfg = Config(VIS_ENCODER=arch.name, MODEL="multimodal_fpl", TEXT_PREFIX_SIZE=vision_prefix,
                 VISION_PREFIX_SIZE=vision_prefix)
    launches = (fused_attention.launches, attention_bwd.launches)
    strat = MultimodalStrategy(cfg, {"0": 0}, ["0"], ["0"], ["0"],
                               runtime=SimpleNamespace(arch=arch, device=torch.device("cuda")))
    assert strat.prompt["vpt"].shape == (vision_prefix, arch.vision_width)
    assert all(v.device.type == "meta" for v in strat._prompt_params())
    assert asked and all(d.type == "cuda" for d in asked)
    assert (fused_attention.launches, attention_bwd.launches) == launches
