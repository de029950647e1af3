"""The port's zero-shot / pseudolabel slice against the JAX package, end to
end on the CPU: the main_clip workflow, FPL pseudolabel selection and the
predict CLI, on the synthetic MNIST-layout fixture with the tiny-test arch.

Both packages load the same OpenAI-layout checkpoint (CLIP_CKPT); the port
runs with device="cpu".  Logits agree within 2e-4 (fp32, as the model
parity tests); probabilities within 1e-5 (the JAX package's CPU path takes a
float64 host softmax, the port's the fp32 CLIP head); everything discrete -
predictions, accuracy, artifact names, pseudolabel sets - is identical.
"""

import json
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

from menghini_neurips23_tpu.config import Config as JaxConfig
from menghini_neurips23_tpu import predict as jax_predict
from menghini_neurips23_tpu.pseudo import pseudolabel_top_k as jax_pseudolabel_top_k
from menghini_neurips23_tpu.runners import main_clip as jax_main_clip
from menghini_neurips23_tpu.runtime import ClipRuntime as JaxClipRuntime
from menghini_neurips23_tpu.training import TextualStrategy as JaxTextualStrategy
from menghini_neurips23_tpu.models import TINY_TEST as JAX_TINY
from menghini_neurips23_tpu_torch import predict
from menghini_neurips23_tpu_torch.config import Config
from menghini_neurips23_tpu_torch.data import dataset_object
from menghini_neurips23_tpu_torch.pseudo import pseudolabel_top_k
from menghini_neurips23_tpu_torch.runners import common, main_clip
from menghini_neurips23_tpu_torch.runtime import ClipRuntime
from menghini_neurips23_tpu_torch.training import TrainingStrategy
from tests.test_torch_parity import _make_state_dict

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CLASSES = ["0", "1", "2"]
K = 4  # pseudolabels per class over the 18-image pool


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    # seed 16: the zero-shot pool probabilities of this checkpoint pass
    # _assert_no_near_ties and send 12 of 18 images to one class (the cascade runs)
    sd = _make_state_dict(JAX_TINY, np.random.default_rng(16))
    path = tmp_path_factory.mktemp("ckpt") / "tiny_openai.pt"
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, path)
    return str(path)


def _kw(root, artifact_dir, ckpt, **extra):
    kw = dict(
        DATASET_NAME="MNIST", DATASET_DIR=str(root.parent), MODEL="clip_baseline",
        VIS_ENCODER="tiny-test", LEARNING_PARADIGM="ssl", PROMPT_TEMPLATE="a photo of a {}",
        BATCH_SIZE=8, OPTIM_SEED=1, SPLIT_SEED=500, CLIP_CKPT=ckpt,
        ARTIFACT_DIR=str(artifact_dir),
    )
    kw.update(extra)
    return kw


@pytest.fixture(scope="module")
def runtimes(ckpt):
    jax_rt = JaxClipRuntime(JaxConfig(VIS_ENCODER="tiny-test", BATCH_SIZE=8, CLIP_CKPT=ckpt))
    port_rt = ClipRuntime(Config(VIS_ENCODER="tiny-test", BATCH_SIZE=8, CLIP_CKPT=ckpt), device="cpu")
    return jax_rt, port_rt


def _listing(root):
    return sorted(
        os.path.relpath(os.path.join(d, f), root) for d, _, fs in os.walk(root) for f in fs
    )


def test_main_clip_workflow_matches_jax(tmp_path, mnist_fixture, runtimes, ckpt):
    root, _ = mnist_fixture
    jax_rt, port_rt = runtimes
    jcfg = JaxConfig(**_kw(root, tmp_path / "jax", ckpt))
    pcfg = Config(**_kw(root, tmp_path / "port", ckpt))
    jresp = jax_main_clip.workflow(jcfg.DATASET_DIR, jcfg, runtime=jax_rt)
    presp = main_clip.workflow(pcfg.DATASET_DIR, pcfg, runtime=port_rt)
    assert presp == jresp
    assert _listing(tmp_path / "port") == _listing(tmp_path / "jax")
    name = "evaluation/MNIST_ssl_clip_baseline_tiny-test_opt_1_spl_500.pickle"
    with open(tmp_path / "jax" / name, "rb") as f:
        jpred = pickle.load(f)
    with open(tmp_path / "port" / name, "rb") as f:
        ppred = pickle.load(f)
    for key in ("images", "predictions", "labels"):
        assert ppred[key] == jpred[key]
    np.testing.assert_allclose(ppred["logits"], jpred["logits"], rtol=2e-4, atol=2e-4)
    jrec = json.loads((tmp_path / "jax" / "results_model_clip_baseline.json").read_text())
    prec = json.loads((tmp_path / "port" / "results_model_clip_baseline.json").read_text())
    assert prec["accuracy"] == jrec["accuracy"] and prec["model"] == jrec["model"]
    assert prec["config"].keys() == jrec["config"].keys()


def _assert_no_near_ties(probs, eps=1e-5):
    """Every decision the leaderboard takes - each row's argmax and every
    comparison of two images' scores for one class - is decided by more than
    eps, so fp32-vs-float64 rounding cannot flip it."""
    top2 = np.sort(probs, axis=1)[:, -2:]
    assert (top2[:, 1] - top2[:, 0]).min() > eps
    for j in range(probs.shape[1]):
        assert np.diff(np.sort(probs[:, j])).min() > eps


def test_pseudolabels_match_jax(tmp_path, mnist_fixture, runtimes, ckpt):
    root, _ = mnist_fixture
    jax_rt, port_rt = runtimes
    pool = [f"train/{c}/{c}_img{i}.png" for c in CLASSES for i in range(6)]
    l2i = {c: i for i, c in enumerate(CLASSES)}
    folder = str(root)
    jcfg = JaxConfig(**_kw(root, tmp_path / "jax", ckpt, MODEL="textual_fpl"))
    pcfg = Config(**_kw(root, tmp_path / "port", ckpt, MODEL="textual_fpl"))
    jstrat = JaxTextualStrategy(jcfg, l2i, CLASSES, CLASSES, CLASSES, runtime=jax_rt)
    pstrat = TrainingStrategy(pcfg, l2i, CLASSES, CLASSES, CLASSES, runtime=port_rt)
    jds = dataset_object("MNIST")(pool, folder, train=True, labels=None, label_map=l2i)
    pds = dataset_object("MNIST")(pool, folder, train=True, labels=None, label_map=l2i)
    jprobs = jstrat._zero_shot_probs(jds.filepaths, CLASSES)
    pprobs = pstrat._zero_shot_probs(pds.filepaths, CLASSES)
    assert pprobs.dtype == np.float32 and pprobs.shape == (18, 3)
    np.testing.assert_allclose(pprobs, jprobs, rtol=0, atol=1e-5)
    _assert_no_near_ties(jprobs)
    assert np.bincount(jprobs.argmax(1), minlength=3).max() > K  # the cascade runs

    jax_pseudolabel_top_k(jcfg, "MNIST", K, jds, CLASSES, l2i, lambda: jprobs)
    pseudolabel_top_k(pcfg, "MNIST", K, pds, CLASSES, l2i, lambda: pprobs)
    assert pds.filepaths == jds.filepaths and pds.labels == jds.labels
    # the reference's arrival-order quirk can leave boards short of K
    assert 0 < len(pds.filepaths) <= K * len(CLASSES)
    assert _listing(tmp_path / "port") == _listing(tmp_path / "jax")
    (name,) = _listing(tmp_path / "jax")
    assert name == "pseudolabels/MNIST_tiny-test_ssl_textual_fpl_4_pseudolabels_split_500.pickle"
    with open(tmp_path / "jax" / name, "rb") as f, open(tmp_path / "port" / name, "rb") as g:
        assert pickle.load(g) == pickle.load(f)


def test_predict_zero_shot_matches_jax(tmp_path, mnist_fixture, ckpt, monkeypatch):
    root, _ = mnist_fixture
    monkeypatch.chdir(tmp_path)
    yml = tmp_path / "pred.yml"
    yml.write_text(f"CLIP_CKPT: {ckpt}\nARTIFACT_DIR: {tmp_path}\n")
    env = dict(
        OPTIM_SEED="1", SPLIT_SEED="500", VIS_ENCODER="tiny-test", DATASET_NAME="MNIST",
        DATASET_DIR=str(root.parent), MODEL="clip_baseline",
    )
    argv = ["--model_config", str(yml), "--learning_paradigm", "ssl",
            "--images", str(root / "test"), "--top_k", "2"]
    want = jax_predict.main(argv + ["--output", str(tmp_path / "jax.json")], env=env)
    got = predict.main(argv + ["--output", str(tmp_path / "port.json")], env=env, device="cpu")
    assert len(got) == len(want) == 18
    assert [p["image"] for p in got] == [p["image"] for p in want]
    assert [p["class"] for p in got] == [p["class"] for p in want]
    assert [[t["class"] for t in p["top_k"]] for p in got] == [
        [t["class"] for t in p["top_k"]] for p in want
    ]
    np.testing.assert_allclose(
        [t["confidence"] for p in got for t in p["top_k"]],
        [t["confidence"] for p in want for t in p["top_k"]], rtol=0, atol=1e-5,
    )
    assert json.loads((tmp_path / "port.json").read_text())["model"] == "clip_baseline"


def _half_size_chw(img):
    """A user transform: PIL image -> CHW float array at half scale."""
    return np.asarray(img, np.float32).transpose(2, 0, 1) / 510.0


@pytest.mark.parametrize("path", ["folded_features", "transform_features", "vision_tokens"])
def test_runtime_passes_match_jax(mnist_fixture, runtimes, path):
    root, _ = mnist_fixture
    jax_rt, port_rt = runtimes
    files = [str(root / f"test/{c}/{c}_img{i}.png") for c in CLASSES for i in range(6)]
    if path == "vision_tokens":
        want = jax_rt.vision_tokens_from_files(files)
        got = port_rt.vision_tokens_from_files(files)
    else:
        tf = _half_size_chw if path == "transform_features" else None
        want = jax_rt.encode_images_from_files(files, transform=tf)
        got = port_rt.encode_images_from_files(files, transform=tf)
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


def test_port_imports_neither_jax_nor_the_jax_package():
    code = (
        "import pkgutil, importlib, sys\n"
        "import menghini_neurips23_tpu_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'menghini_neurips23_tpu' or m.startswith('menghini_neurips23_tpu.'))\n"
        "assert len(names) > 20, names\n"
        "assert not bad, bad\n"
        "print(len(names))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True,
        timeout=120,
    )
    assert out.returncode == 0, out.stderr


def test_entry_points_refuse_to_run_without_a_card(monkeypatch, mnist_fixture, tmp_path):
    root, _ = mnist_fixture
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = Config(VIS_ENCODER="tiny-test")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ClipRuntime(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TrainingStrategy(cfg, {"0": 0}, ["0"], ["0"], ["0"])
    monkeypatch.chdir(tmp_path)
    yml = tmp_path / "c.yml"
    yml.write_text("BATCH_SIZE: 8\n")
    env = dict(DATASET_NAME="MNIST", DATASET_DIR=str(root.parent), MODEL="clip_baseline",
               VIS_ENCODER="tiny-test")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main_clip.main(["--model_config", str(yml), "--learning_paradigm", "ssl"], env=env)


@pytest.mark.parametrize(
    "env_extra, exc, match",
    [
        ({"MODEL": "textual_fpl"}, NotImplementedError, "CoOp training slice"),
        ({"MODEL": "no_such_model"}, ValueError, "Unknown MODEL"),
        ({"PROFILE_DIR": "prof"}, NotImplementedError, "PROFILE_DIR"),
        ({"COMPILE_CACHE_DIR": "cache"}, NotImplementedError, "COMPILE_CACHE_DIR"),
    ],
    ids=["training-model", "unknown-model", "profile-dir", "compile-cache-dir"],
)
def test_main_template_rejects_what_this_slice_lacks(tmp_path, mnist_fixture, env_extra, exc, match):
    root, _ = mnist_fixture
    yml = tmp_path / "c.yml"
    yml.write_text("BATCH_SIZE: 8\n")
    env = dict(DATASET_NAME="MNIST", DATASET_DIR=str(root.parent), MODEL="clip_baseline",
               VIS_ENCODER="tiny-test")
    env.update(env_extra)
    called = []
    with pytest.raises(exc, match=match):
        common.main_template(lambda *a, **k: called.append(a), argv=[
            "--model_config", str(yml), "--learning_paradigm", "ssl"], env=env, device="cpu")
    assert not called


def test_device_topk_raises_naming_its_slice(tmp_path):
    from menghini_neurips23_tpu_torch.pseudo import compute_pseudo_labels

    ds = dataset_object("MNIST")(["0/a.png"], str(tmp_path), labels=None, label_map={"0": 0})
    with pytest.raises(NotImplementedError, match="device top-k"):
        compute_pseudo_labels(np.ones((1, 1), np.float32), ds, ["0"], {"0": 0}, 1,
                              method="device")


FRAMED = ("EuroSAT", "DTD", "RESICS45", "FGVCAircraft", "MNIST", "Flowers102")


@pytest.mark.parametrize("dataset", FRAMED)
def test_class_splits_and_tokens_match_jax(tmp_path, dataset):
    """The copied data layer keeps the seeded NumPy call sequences: the same
    class splits, few-shot picks and train/val splits as the JAX package (the
    bundled class files, every split seed), and the tokenizer gives the same
    ids for every class prompt."""
    from menghini_neurips23_tpu.data import prepare as jax_prepare
    from menghini_neurips23_tpu.tokenizer import get_tokenizer as jax_get_tokenizer
    from menghini_neurips23_tpu_torch.data import prepare
    from menghini_neurips23_tpu_torch.data.templates import format_prompt
    from menghini_neurips23_tpu_torch.tokenizer import get_tokenizer

    for seed in (500, 0, 200):
        got = prepare.get_class_names(dataset, str(tmp_path), seed)
        assert got == jax_prepare.get_class_names(dataset, str(tmp_path), seed)
    classes = got[0]
    files = [f"{c}/img{i}.png" for c in classes for i in range(5)]
    labels = [c for c in classes for _ in range(5)]
    assert prepare.sample_few_shots(files, labels, classes, 2, 1) == jax_prepare.sample_few_shots(
        files, labels, classes, 2, 1
    )
    for a, b in zip(prepare.train_val_split(files, labels, 0.8, 0),
                    jax_prepare.train_val_split(files, labels, 0.8, 0)):
        np.testing.assert_array_equal(a, b)
    prompts = [format_prompt("a photo of a {}", c) for c in classes]
    np.testing.assert_array_equal(
        get_tokenizer(None).tokenize(prompts), jax_get_tokenizer(None).tokenize(prompts)
    )
