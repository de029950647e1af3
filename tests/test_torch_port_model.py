"""The port's CLIP towers (menghini_neurips23_tpu_torch.models) against the
JAX package's, on the CPU, at the tiny-test width.

Weights cross between the packages either through `from_jax_params` (the JAX
package's random init carried across) or through one OpenAI-layout .pt that
both packages' `load_clip` read.  Tolerance 2e-4 in fp32, as the JAX
package's own torch-oracle parity tests use; 3e-2 for bf16, where the two
frameworks round at different points inside the matmuls.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from menghini_neurips23_tpu.models import TINY_TEST as JAX_TINY
from menghini_neurips23_tpu.models import init_clip_params as jax_init_clip_params
from menghini_neurips23_tpu.models import load_clip as jax_load_clip
from menghini_neurips23_tpu.models import save_npz as jax_save_npz
from menghini_neurips23_tpu.models.clip import CLIP as JaxCLIP
from menghini_neurips23_tpu.models.clip import precast_matmul_params as jax_precast
from menghini_neurips23_tpu_torch.models import (
    TINY_TEST,
    build_clip,
    from_jax_params,
    init_clip_params,
    load_clip,
    precast_matmul_params,
)
from tests.test_torch_parity import _make_state_dict

torch.set_num_threads(2)

TOL = 2e-4


def _ids(rng, n, a=TINY_TEST):
    ids = np.zeros((n, a.context_length), np.int32)
    ids[:, 0] = a.vocab_size - 2  # sot
    for r in range(n):
        k = 2 + r
        ids[r, 1 : 1 + k] = rng.integers(1, 400, k)
        ids[r, 1 + k] = a.vocab_size - 1  # eot (max id)
    return ids


@pytest.fixture(scope="module")
def carried():
    """JAX random init -> numpy tree -> from_jax_params -> the port's model."""
    model, params = jax_init_clip_params(JAX_TINY, seed=0)
    params = jax.tree.map(np.asarray, params)
    port = build_clip(TINY_TEST, from_jax_params(params))
    rng = np.random.default_rng(7)
    images = rng.normal(0, 1, (3, 32, 32, 3)).astype(np.float32)
    ids = _ids(rng, 4)
    return model, params, port, images, ids


def _jax(model, params, *args, method):
    return np.asarray(model.apply(params, *map(jnp.asarray, args), method=method))


def _port(port, *args, method):
    with torch.inference_mode():
        out = getattr(port, method)(*[torch.from_numpy(np.array(a)) for a in args])
    return out.float().numpy()


STAGES = [
    "vision_embed", "vision_encode_tokens", "text_embed_ids", "text_encode_embeddings",
    "encode_image", "encode_text", "get_logit_scale",
]


@pytest.mark.parametrize("method", STAGES)
def test_staged_method_matches_jax(carried, method):
    model, params, port, images, ids = carried
    if method in ("vision_embed", "encode_image"):
        args_j = args_p = (images,)
    elif method == "vision_encode_tokens":
        tokens = _jax(model, params, images, method="vision_embed")
        args_j = args_p = (tokens,)
    elif method == "text_embed_ids":
        args_j, args_p = (ids,), (ids.astype(np.int64),)
    elif method == "text_encode_embeddings":
        emb = _jax(model, params, ids, method="text_embed_ids")
        eot = ids.argmax(-1)
        args_j, args_p = (emb, eot.astype(np.int32)), (emb, eot.astype(np.int64))
    elif method == "encode_text":
        args_j, args_p = (ids,), (ids.astype(np.int64),)
    else:
        args_j = args_p = ()
    want = _jax(model, params, *args_j, method=method)
    got = _port(port, *args_p, method=method)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_openai_checkpoint_loads_the_same_in_both_packages(tmp_path):
    rng = np.random.default_rng(42)
    sd = _make_state_dict(JAX_TINY, rng)
    path = tmp_path / "tiny_openai.pt"
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, path)
    jarch, jmodel, jparams = jax_load_clip(str(path))
    arch, state = load_clip(str(path))
    assert arch == TINY_TEST and jarch.name == arch.name
    port = build_clip(arch, state)
    images = rng.normal(0, 1, (2, 32, 32, 3)).astype(np.float32)
    ids = _ids(rng, 3)
    np.testing.assert_allclose(
        _port(port, images, method="encode_image"),
        _jax(jmodel, jparams, images, method="encode_image"), rtol=TOL, atol=TOL,
    )
    np.testing.assert_allclose(
        _port(port, ids.astype(np.int64), method="encode_text"),
        _jax(jmodel, jparams, ids, method="encode_text"), rtol=TOL, atol=TOL,
    )


def test_jax_npz_export_loads_through_from_jax_params(tmp_path, carried):
    _, params, _, _, _ = carried
    path = str(tmp_path / "tiny.npz")
    jax_save_npz(params, path)
    arch, state = load_clip(path)
    assert arch == TINY_TEST
    want = from_jax_params(params)
    assert state.keys() == want.keys()
    for k in want:
        torch.testing.assert_close(state[k], want[k], rtol=0, atol=0)


def test_bf16_towers_agree_with_jax_bf16(carried):
    _, params, _, images, ids = carried
    jmodel = JaxCLIP(JAX_TINY, dtype=jnp.bfloat16)
    jparams = jax_precast(params, jnp.bfloat16)
    port = precast_matmul_params(
        build_clip(TINY_TEST, from_jax_params(params), dtype=torch.bfloat16), torch.bfloat16
    )
    for method, arg_j, arg_p in (
        ("encode_image", images, images),
        ("encode_text", ids, ids.astype(np.int64)),
    ):
        want = _jax(jmodel, jparams, arg_j, method=method).astype(np.float32)
        np.testing.assert_allclose(_port(port, arg_p, method=method), want, rtol=3e-2, atol=3e-2)


def test_precast_weights_give_identical_bf16_outputs(carried):
    _, params, _, images, ids = carried
    sd = from_jax_params(params)
    plain = build_clip(TINY_TEST, sd, dtype=torch.bfloat16)
    cast = precast_matmul_params(build_clip(TINY_TEST, sd, dtype=torch.bfloat16), torch.bfloat16)
    assert cast.text.transformer.resblocks[0].attn.in_proj_weight.dtype == torch.bfloat16
    assert cast.visual.ln_pre.weight.dtype == torch.float32
    with torch.inference_mode():
        x = torch.from_numpy(images)
        torch.testing.assert_close(cast.encode_image(x), plain.encode_image(x), rtol=0, atol=0)
        t = torch.from_numpy(ids.astype(np.int64))
        torch.testing.assert_close(cast.encode_text(t), plain.encode_text(t), rtol=0, atol=0)


def test_random_init_is_seeded_and_fills_every_parameter():
    a = init_clip_params(TINY_TEST, seed=0)
    b = init_clip_params(TINY_TEST, seed=0)
    c = init_clip_params(TINY_TEST, seed=1)
    model = build_clip(TINY_TEST, a)  # strict load: every key present
    assert set(a) == set(model.state_dict())
    for k in a:
        torch.testing.assert_close(a[k], b[k], rtol=0, atol=0)
    assert not torch.equal(a["visual.conv1_kernel"], c["visual.conv1_kernel"])
    assert torch.isclose(model.get_logit_scale(), torch.tensor(1 / 0.07))
    assert torch.all(a["text.transformer.resblocks.0.ln_1.weight"] == 1)
