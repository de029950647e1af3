"""The plain reference against the port's CPU path at tiny-test size, and the
harness's inputs.  (On the CPU the port runs its kernels' plain versions.)"""

import ast
import os

import numpy as np
import pytest
import torch

from portbench.harness import inputs
from portbench.harness.manifest import PKG_DIR
from portbench.reference import clip as rclip, leaderboard, tokenizer as rtok
from portbench.tests.fixtures import TINY

torch.set_num_threads(2)


def test_reference_imports_nothing_of_the_program():
    for name in os.listdir(os.path.join(PKG_DIR, "reference")):
        if not name.endswith(".py"):
            continue
        with open(os.path.join(PKG_DIR, "reference", name)) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            mods = ([a.name for a in node.names] if isinstance(node, ast.Import)
                    else [node.module] if isinstance(node, ast.ImportFrom) else [])
            for m in mods:
                top = (m or "").split(".")[0]
                assert top not in ("jax", "jaxlib", "flax", "menghini_neurips23_tpu",
                                   "menghini_neurips23_tpu_torch"), (name, m)
                assert m != "portbench.harness.port", name


def test_tokenizer_matches_the_port():
    from menghini_neurips23_tpu_torch.models.prompts import build_prompt_token_ids, truncate_context
    from menghini_neurips23_tpu_torch.tokenizer import ClipTokenizer

    tok = ClipTokenizer(None)
    names = inputs.class_names(7, 102, (1, 3), (3, 9))
    ids = rtok.tokenize(rtok.coop_prompts(names, 16))
    assert np.array_equal(ids, build_prompt_token_ids(tok, names, 16))
    assert np.array_equal(rtok.truncate(ids), truncate_context(ids))
    tmpl = rtok.template_prompts(names)
    assert np.array_equal(rtok.tokenize(tmpl), tok.tokenize(tmpl))


def test_class_names_keep_their_shapes_across_seeds():
    lengths = set()
    for seed in (0, 1, 2**31 + 5, 3_000_000_007):
        names = inputs.class_names(seed, 102, (1, 3), (3, 9))
        assert len(set(names)) == 102
        lengths.add(tuple(sorted(len(n) for n in names)))
        assert rtok.truncate(rtok.tokenize(rtok.coop_prompts(names, 16))).shape[1] == 48
    assert len(lengths) == 1
    a, b = inputs.balanced_labels(1, "x", 5, 3), inputs.balanced_labels(2, "x", 5, 3)
    assert sorted(a) == sorted(b) and not np.array_equal(a, b)


@pytest.fixture(scope="module")
def model():
    from menghini_neurips23_tpu_torch.models import build_clip, get_arch

    sd = inputs.clip_weights(TINY, 11, "cpu")
    return sd, build_clip(get_arch("tiny-test"), sd, torch.float32, "cpu")


def test_weights_follow_the_seed_and_the_published_names(model):
    sd, port = model
    again = inputs.clip_weights(TINY, 11, "cpu")
    assert all(torch.equal(sd[k], again[k]) for k in sd)
    other = inputs.clip_weights(TINY, 12, "cpu")
    assert not torch.equal(sd["visual.proj"], other["visual.proj"])
    assert set(sd) == set(port.state_dict())


def test_reference_text_matches_the_port(model):
    from menghini_neurips23_tpu_torch.models.prompts import coop_text_features

    sd, port = model
    names = inputs.class_names(3, 5, (1, 3), (3, 9))
    ids = torch.tensor(rtok.truncate(rtok.tokenize(rtok.coop_prompts(names, 4))))
    prefix = torch.tensor(inputs.prompt_init(3, (4, 32)))
    with torch.no_grad():
        want = coop_text_features(port, prefix, ids)
        got = rclip.text_features(sd, TINY, ids, prefix)
        plain = rclip.text_features(sd, TINY, ids)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(plain, port.encode_text(ids), rtol=1e-5, atol=1e-5)


def test_reference_image_matches_the_port(model):
    from menghini_neurips23_tpu_torch.config import Config
    from menghini_neurips23_tpu_torch.models.prompts import vpt_image_features
    from menghini_neurips23_tpu_torch.ops.patch_embed import fold_normalization, patch_tokens

    sd, port = model
    imgs = inputs.images(5, 6, 32, "cpu")
    kf, bias = fold_normalization(sd["visual.conv1_kernel"].numpy())
    toks = port.visual.tokens_from_patches(
        patch_tokens(imgs, torch.from_numpy(kf), 16, torch.float32, torch.from_numpy(bias)))
    ref = rclip.image_tokens(sd, TINY, imgs)
    torch.testing.assert_close(ref, toks, rtol=1e-4, atol=1e-4)
    prefix = torch.tensor(inputs.prompt_init(5, (4, 32)))
    with torch.no_grad():
        torch.testing.assert_close(rclip.image_features(sd, TINY, ref, prefix),
                                   vpt_image_features(port, prefix, tokens=ref),
                                   rtol=1e-5, atol=1e-5)
    assert Config(MODEL="visual_fpl").MODALITY == "image"


@pytest.mark.parametrize("k,n,c", [(4, 40, 5), (2, 64, 3), (20, 30, 4)])
def test_frozen_leaderboard_matches_the_port(k, n, c):
    from menghini_neurips23_tpu_torch.pseudo.engine import leaderboard_top_k

    rng = np.random.default_rng(k * n)
    logits = rng.standard_normal((n, c)) * 3
    logits[:, 0] += 2  # one class takes most argmaxes: the boards overflow and cascade
    probs = (np.exp(logits) / np.exp(logits).sum(1, keepdims=True)).astype(np.float32)
    paths = [f"p{i}" for i in range(n)]
    ids = list(range(10, 10 + c))
    assert leaderboard.top_k(probs, paths, k, ids) == tuple(leaderboard_top_k(probs, paths, k, ids))
