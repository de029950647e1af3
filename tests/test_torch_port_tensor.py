"""The port's tensor parallelism (menghini_neurips23_tpu_torch/parallel/
tensor.py, `MESH_SHAPE "d,m"` with m > 1) on the CPU, in spawned gloo
groups, against one process and against the JAX package's
`clip_param_sharding`.

The arch is registered here, never in either package: vision and text
width 128, two heads of 64 in each tower, so a model axis of 2 splits
both; its weights are an OpenAI-layout checkpoint from a seed, whose
shapes both packages infer (a "custom" arch of 2 + 2 heads).  Everything
runs in fp32:

- the shard function cuts whole heads (the rows of q, k and v of a head,
  its columns of out_proj) and 4W/m MLP rows, and the shards put back
  together are the full state dict;
- a two-rank model group (`MESH_SHAPE "1,2"`) encodes images and text
  within 2e-5 of the JAX package's sharded forward on a (4, 2) CPU mesh,
  and its CoOp and deep VPT prompt gradients are within 1e-5 of one
  process's, the same bits on both model ranks;
- a (2, 2) group of four ranks runs main_ssl textual_fpl and main_ul
  visual_fpl as one process does: the same artifact names and pseudolabel
  bytes, prompts and logits within 1e-4 (the port's workflow tolerance),
  and every rank's final prompts the same bits.

Each process runs its torch on one thread.
"""

import dataclasses
import pickle
import re
import textwrap

import numpy as np
import pytest
import torch

import tests.test_torch_port_parallel as tpp
from menghini_neurips23_tpu_torch.config import Config
from menghini_neurips23_tpu_torch.models import VIT_B32, VIT_L14, TINY_TEST, build_clip
from menghini_neurips23_tpu_torch.models.configs import CLIPArch
from menghini_neurips23_tpu_torch.parallel import Mesh, mesh_from_config, tensor
from menghini_neurips23_tpu_torch.parallel.mesh import check_model_axis, model_parallelism
from tests.conftest import make_mnist_fixture
from tests.test_torch_parity import _make_state_dict
from tests.torch_port_fixtures import native_build_outside_checkout  # noqa: F401

TP_ARCH = CLIPArch(name="tp-test", embed_dim=32, image_resolution=32, vision_layers=2,
                   vision_width=128, vision_patch_size=16, context_length=77, vocab_size=514,
                   transformer_width=128, transformer_heads=2, transformer_layers=2)

WORKER = textwrap.dedent(
    """
    import sys
    import numpy as np
    import torch
    torch.set_num_threads(1)
    from menghini_neurips23_tpu_torch.config import Config
    from menghini_neurips23_tpu_torch.models import build_clip, load_clip
    from menghini_neurips23_tpu_torch.models.prompts import coop_text_features, vpt_image_features
    from menghini_neurips23_tpu_torch.parallel import initialize_from_env, multihost, tensor
    from menghini_neurips23_tpu_torch.parallel.mesh import check_model_axis, mesh_from_config

    ckpt, inputs, out, spec = sys.argv[1:5]
    group = initialize_from_env(device="cpu")
    mesh = mesh_from_config(Config(MESH_SHAPE=spec))
    arch, sd = load_clip(ckpt)
    check_model_axis(mesh.model, arch)
    model = build_clip(arch, sd, tp=tensor.from_layout())
    x = {k: torch.from_numpy(v) for k, v in np.load(inputs).items()}
    res = {}
    with torch.no_grad():
        res["image"] = model.encode_image(x["images"])
        res["text"] = model.encode_text(x["ids"])
    coop = x["coop"].clone().requires_grad_(True)
    f = coop_text_features(model, coop, x["prompt_ids"])
    # losses of the training loss's scale: means over the rows
    res["coop_grad"], = torch.autograd.grad((f * x["w_text"]).mean(), coop)
    vpt, deep = (x[k].clone().requires_grad_(True) for k in ("vpt", "deep"))
    f = vpt_image_features(model, vpt, images=x["images"], deep_prompts=deep)
    res["vpt_grad"], res["deep_grad"] = torch.autograd.grad((f * x["w_image"]).mean(), [vpt, deep])
    res["model_all_reduces"] = torch.tensor(tensor.model_all_reduce_.calls)
    np.savez(out % multihost.process_index(), **{k: v.numpy() for k, v in res.items()})
    if group is not None:
        import torch.distributed as dist
        dist.destroy_process_group()
    """
)

# the runner of tests/test_torch_port_parallel.py, which also writes the
# rank's final prompts (the live strategy's) to prompts_rank<RANK>.pkl
RUNNER = textwrap.dedent(
    """
    import os
    import pickle
    import sys
    import torch
    torch.set_num_threads(1)
    from menghini_neurips23_tpu_torch.runners import common, main_ssl, main_trzsl, main_ul
    paradigm = sys.argv[2]
    runner = {"ssl": main_ssl, "trzsl": main_trzsl, "ul": main_ul}[paradigm]
    seen, run_strategy = {}, common.run_strategy

    def recorded(strategy, *a):
        seen["strategy"] = strategy
        return run_strategy(strategy, *a)

    common.run_strategy = recorded
    runner.main(["--model_config", sys.argv[1], "--learning_paradigm", paradigm],
                device="cpu")
    with open(f"prompts_rank{os.environ.get('RANK', '0')}.pkl", "wb") as f:
        pickle.dump(seen["strategy"].epoch_parameters(), f)
    """
)


@pytest.fixture(scope="module")
def tp_ckpt(tmp_path_factory):
    sd = _make_state_dict(TP_ARCH, np.random.default_rng(21))
    path = tmp_path_factory.mktemp("tp_ckpt") / "tp_openai.pt"
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, path)
    return sd, str(path)


# ------------------------------------------------------------ the shards
def test_shards_follow_heads_and_put_back_together():
    from menghini_neurips23_tpu_torch.models import init_clip_params

    sd = init_clip_params(TP_ARCH, seed=3)
    W, m = TP_ARCH.vision_width, 2  # the text tower's width too
    shards = [tensor.shard_state_dict(sd, m, r) for r in range(m)]
    blocks = 0
    for key, v in sd.items():
        parts = [s[key] for s in shards]
        match = re.match(r"(visual|text)\.transformer\.resblocks\.\d+\.", key)
        suffix = key[match.end():] if match else None
        blocks += suffix == "attn.in_proj_weight"
        if suffix in ("attn.in_proj_weight", "attn.in_proj_bias"):
            # rank r holds rows [r*W/m, (r+1)*W/m) of each of q, k and v: head r
            for r, p in enumerate(parts):
                want = torch.cat([v[j * W + r * W // m: j * W + (r + 1) * W // m]
                                  for j in range(3)])
                assert torch.equal(p, want)
        elif suffix in ("mlp.c_fc.weight", "mlp.c_fc.bias"):
            assert torch.equal(torch.cat(parts), v)
        elif suffix in ("attn.out_proj.weight", "mlp.c_proj.weight"):
            assert torch.equal(torch.cat(parts, dim=1), v)
        else:  # LayerNorms, output biases, embeddings, projections: whole
            assert all(torch.equal(p, v) for p in parts), key
    assert blocks == TP_ARCH.vision_layers + TP_ARCH.transformer_layers
    assert all(p.is_contiguous() for p in shards[1].values())
    assert tensor.shard_state_dict(sd, 1, 0) == sd


def test_sharded_modules_take_their_shapes_and_refuse_without_a_group():
    sd = _make_state_dict(TP_ARCH, np.random.default_rng(2))
    from menghini_neurips23_tpu_torch.models import convert_state_dict

    _, ours = convert_state_dict(sd)
    model = build_clip(TP_ARCH, ours, tp=tensor.TensorParallel(2, 1, None))
    blk = model.visual.transformer.resblocks[0]
    assert blk.attn.heads == 1 and blk.attn.in_proj_weight.shape == (192, 128)
    assert blk.attn.out_proj.weight.shape == (128, 64) and blk.mlp["c_fc"].weight.shape == (256, 128)
    with pytest.raises(ValueError, match="needs its process group"):
        with torch.no_grad():
            model.encode_text(torch.zeros(1, 8, dtype=torch.long))


@pytest.mark.parametrize("arch, ok", [(VIT_B32, (1, 2, 4)), (VIT_L14, (1, 2, 4)),
                                      (TINY_TEST, (1,)), (TP_ARCH, (1, 2))],
                         ids=["ViT-B32", "ViT-L14", "tiny-test", "tp-test"])
def test_model_axis_must_divide_both_head_counts(arch, ok):
    for m in (1, 2, 3, 4):
        if m in ok:
            check_model_axis(m, arch)
            continue
        with pytest.raises(ValueError, match=f"{arch.vision_heads} vision heads and "
                                             f"{arch.transformer_heads} text heads"):
            check_model_axis(m, arch)
    assert model_parallelism(Mesh(2, 2)) == 2 and model_parallelism() == 1
    assert mesh_from_config(Config(MESH_SHAPE="1,1")) == Mesh(1, 1)


# ----------------------------------------------- a two-rank model group
def _jax_sharded_forward(sd, images, ids):
    import jax

    from menghini_neurips23_tpu.models import convert_state_dict as jax_convert
    from menghini_neurips23_tpu.models.clip import CLIP as JaxCLIP
    from menghini_neurips23_tpu.parallel import clip_param_sharding, make_mesh

    arch, params = jax_convert(sd)
    model = JaxCLIP(arch)
    mesh = make_mesh((4, 2))
    sharded = jax.device_put(params, clip_param_sharding(mesh, params))
    image = jax.jit(lambda p, x: model.apply(p, x, method="encode_image"))(sharded, images)
    text = jax.jit(lambda p, x: model.apply(p, x, method="encode_text"))(sharded, ids)
    return np.asarray(image), np.asarray(text)


def test_two_rank_model_group_matches_jax_sharding_and_one_process(tmp_path, tp_ckpt):
    sd, ckpt = tp_ckpt
    a = TP_ARCH
    rng = np.random.default_rng(4)
    ids = np.zeros((8, 16), np.int64)
    ids[:, 0] = a.vocab_size - 2
    for r in range(8):
        ids[r, 1: 3 + r % 5] = rng.integers(1, 400, 2 + r % 5)
        ids[r, 3 + r % 5] = a.vocab_size - 1
    inputs = {
        "images": rng.normal(0, 1, (8, 32, 32, 3)).astype(np.float32), "ids": ids,
        "prompt_ids": ids[:3], "coop": rng.normal(0, 0.02, (4, 128)).astype(np.float32),
        "w_text": rng.normal(0, 1, (3, a.embed_dim)).astype(np.float32),
        "vpt": rng.normal(0, 0.02, (4, 128)).astype(np.float32),
        "deep": rng.normal(0, 0.02, (1, 4, 128)).astype(np.float32),
        "w_image": rng.normal(0, 1, (8, a.embed_dim)).astype(np.float32),
    }
    np.savez(tmp_path / "inputs.npz", **inputs)
    script = tmp_path / "worker.py"
    script.write_text(WORKER)
    env = {k: v for k, v in tpp.os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")}
    env.update(PYTHONPATH=str(tpp.REPO) + tpp.os.pathsep + env.get("PYTHONPATH", ""),
               OMP_NUM_THREADS="1")
    port = tpp._free_port()
    procs = []
    for tag, n, spec in (("one", 1, ""), ("group", 2, "1,2")):
        for rank in range(n):
            penv = dict(env)
            if n > 1:
                penv.update(RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE=str(n),
                            MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
            procs.append(tpp.subprocess.Popen(
                [tpp.sys.executable, str(script), ckpt, str(tmp_path / "inputs.npz"),
                 str(tmp_path / f"{tag}_%d.npz"), spec], env=penv, cwd=str(tmp_path),
                stdout=tpp.subprocess.PIPE, stderr=tpp.subprocess.STDOUT))
    tpp._finish(procs)
    one = dict(np.load(tmp_path / "one_0.npz"))
    ranks = [dict(np.load(tmp_path / f"group_{r}.npz")) for r in range(2)]
    # forward: 2 all-reduces a block; grads: the text tower's 2 blocks and
    # the vision tower's, forward and backward
    layers = a.vision_layers + a.transformer_layers
    assert int(ranks[0]["model_all_reduces"]) == 2 * layers + 4 * layers
    assert int(one["model_all_reduces"]) == 0
    for key in one:  # both model ranks hold the same bits
        np.testing.assert_array_equal(ranks[1][key], ranks[0][key], err_msg=key)
    want_image, want_text = _jax_sharded_forward(sd, inputs["images"], ids)
    np.testing.assert_allclose(ranks[0]["image"], want_image, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(ranks[0]["text"], want_text, rtol=2e-5, atol=2e-5)
    for key in ("coop_grad", "vpt_grad", "deep_grad"):
        assert np.abs(one[key]).max() > 1e-2, key  # the gradients are not vacuous
        np.testing.assert_allclose(ranks[0][key], one[key], rtol=1e-5, atol=1e-5, err_msg=key)


# ------------------------------------------------ (2, 2): four ranks
@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    root = tmp_path_factory.mktemp("tp_data")
    make_mnist_fixture(root / "MNIST")
    return root


@pytest.mark.parametrize("model, paradigm, cfg", [
    ("textual_fpl", "ssl", {}),
    ("visual_fpl", "ul", {"EPOCHS": 2}),
], ids=["ssl-textual_fpl", "ul-visual_fpl"])
def test_data_by_model_group_matches_one_process(monkeypatch, tmp_path, dataset, tp_ckpt, model,
                                                 paradigm, cfg):
    _, ckpt = tp_ckpt
    monkeypatch.setattr(tpp, "RUNNER", RUNNER)
    cfg = {**tpp.BASE_CFG, **cfg}
    single = tpp._start(tmp_path, "single", 1, dataset, ckpt, model, paradigm, cfg, None)
    group = tpp._start(tmp_path, "group", 4, dataset, ckpt, model, paradigm,
                       {**cfg, "MESH_SHAPE": "'2,2'"}, None)
    tpp._finish(single[1])
    outs = tpp._finish(group[1])
    assert "laid out as 2 data x 2 model ranks: rank 0 is data 0, model 0" in outs[0]
    assert "laid out as" not in outs[1]  # rank 0 alone logs
    tpp._assert_same_run(single[0], group[0], model, exact=False)
    prompts = []
    for rank in range(4):
        with open(tmp_path / "group" / f"prompts_rank{rank}.pkl", "rb") as f:
            prompts.append(pickle.load(f))
    with open(tmp_path / "single" / "prompts_rank0.pkl", "rb") as f:
        one = pickle.load(f)
    for rank in range(1, 4):
        for x, y in zip(prompts[rank], prompts[0]):
            np.testing.assert_array_equal(x, y)
    for x, y in zip(prompts[0], one):
        np.testing.assert_allclose(x, y, rtol=1e-4, atol=1e-4)


def test_tp_arch_is_not_registered_in_either_package():
    from menghini_neurips23_tpu.models import configs as jax_configs
    from menghini_neurips23_tpu_torch.models import configs

    assert TP_ARCH.name not in configs.ARCHS and TP_ARCH.name not in jax_configs.ARCHS
    assert dataclasses.replace(TP_ARCH).vision_heads == 2
