"""HuggingFace-layout checkpoints, `save_npz` and the convert CLI of the
port (menghini_neurips23_tpu_torch/models/convert.py) against the JAX
package's (menghini_neurips23_tpu/models/convert.py).

No download: the HuggingFace `CLIPModel` dict is built from an
OpenAI-layout one by `tests/test_torch_parity.py`'s `_openai_to_hf`.
"""

import subprocess
import sys

import numpy as np
import pytest
import torch

from menghini_neurips23_tpu.models import TINY_TEST as JAX_TINY
from menghini_neurips23_tpu.models import convert as jax_convert
from menghini_neurips23_tpu.models.clip import CLIP as JaxCLIP
from menghini_neurips23_tpu_torch.models import (
    build_clip,
    convert_hf_state_dict,
    convert_state_dict,
    from_jax_params,
    is_hf_state_dict,
    load_clip,
    save_npz,
    to_jax_params,
)
from tests.test_torch_parity import _make_state_dict, _openai_to_hf
from tests.test_torch_port_parallel import REPO


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    """(OpenAI numpy dict, HF numpy dict, OpenAI .pt path, HF .pt path)."""
    root = tmp_path_factory.mktemp("convert")
    sd = _make_state_dict(JAX_TINY, np.random.default_rng(8))
    hf = _openai_to_hf(sd, JAX_TINY)
    paths = []
    for name, d in (("openai.pt", sd), ("hf.pt", hf)):
        torch.save({k: torch.from_numpy(np.array(v)) for k, v in d.items()},
                   root / name)
        paths.append(str(root / name))
    return sd, hf, *paths


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        return {k: v for name in sorted(tree) for k, v in _leaves(tree[name],
                                                                  f"{prefix}/{name}").items()}
    return {prefix: np.asarray(tree)}


def test_hf_checkpoint_loads_within_2e4_of_the_jax_conversion(checkpoints):
    import jax.numpy as jnp

    sd, hf, openai_pt, hf_pt = checkpoints
    assert is_hf_state_dict(hf) and not is_hf_state_dict(sd)
    arch, ours = load_clip(hf_pt)
    jarch, params = jax_convert.convert_hf_state_dict(hf)
    assert arch.name == jarch.name == "tiny-test"
    # the same state dict as the OpenAI layout gives
    _, from_openai = load_clip(openai_pt)
    assert sorted(ours) == sorted(from_openai)
    assert all(torch.equal(ours[k], from_openai[k]) for k in ours)
    model = build_clip(arch, ours)
    rng = np.random.default_rng(3)
    images = rng.normal(0, 1, (3, 32, 32, 3)).astype(np.float32)
    ids = np.zeros((3, 77), np.int64)
    ids[:, 0] = arch.vocab_size - 2
    ids[:, 1:5] = rng.integers(1, 400, (3, 4))
    ids[:, 5] = arch.vocab_size - 1
    with torch.no_grad():
        got_image = model.encode_image(torch.from_numpy(images)).numpy()
        got_text = model.encode_text(torch.from_numpy(ids)).numpy()
    jmodel = JaxCLIP(jarch)
    want_image = np.asarray(jmodel.apply(params, jnp.asarray(images), method="encode_image"))
    want_text = np.asarray(jmodel.apply(params, jnp.asarray(ids), method="encode_text"))
    np.testing.assert_allclose(got_image, want_image, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(got_text, want_text, rtol=2e-4, atol=2e-4)
    # and the converted weights themselves, leaf for leaf
    for k, v in _leaves(to_jax_params(convert_hf_state_dict(hf)[1])).items():
        np.testing.assert_array_equal(v, _leaves(params)[k], err_msg=k)


@pytest.mark.parametrize("layout", ["openai", "hf"])
def test_convert_cli_writes_the_jax_packages_npz(tmp_path, checkpoints, layout):
    sd, hf, openai_pt, hf_pt = checkpoints
    src = openai_pt if layout == "openai" else hf_pt
    out = tmp_path / "clip.npz"
    proc = subprocess.run([sys.executable, "-m", "menghini_neurips23_tpu_torch.models.convert",
                           src, str(out)], cwd=str(REPO), capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert f"converted {src} (tiny-test) -> {out}" in proc.stdout
    _, want = (jax_convert.convert_state_dict(sd) if layout == "openai"
               else jax_convert.convert_hf_state_dict(hf))
    got = _leaves(jax_convert.load_npz(str(out)))
    want = _leaves(want)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].shape == want[k].shape and got[k].dtype == np.float32, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    # the port reads its own export back to the same state dict
    arch, back = load_clip(str(out))
    _, direct = convert_state_dict(sd)
    assert arch.name == "tiny-test" and sorted(back) == sorted(direct)
    assert all(torch.equal(back[k], direct[k]) for k in back)


def test_convert_cli_usage_and_save_npz_round_trip(tmp_path):
    from menghini_neurips23_tpu_torch.models import convert, load_npz

    assert convert.main(["only-one-argument"]) == 2
    _, params = jax_convert.convert_state_dict(_make_state_dict(JAX_TINY,
                                                                np.random.default_rng(1)))
    params = {"params": {k: v for k, v in params["params"].items()}}
    save_npz(params, str(tmp_path / "p.npz"))
    back = load_npz(str(tmp_path / "p.npz"))
    a, b = _leaves(back), _leaves(params)
    assert sorted(a) == sorted(b) and all(np.array_equal(a[k], b[k]) for k in b)
    # to_jax_params inverts from_jax_params
    c = _leaves(to_jax_params(from_jax_params(params)))
    assert sorted(c) == sorted(b) and all(np.array_equal(c[k], b[k]) for k in b)
