"""BENCHMARK.json and the files it names, by the contract's form."""

import json
import os

import pytest

from portbench.harness import manifest
from portbench.harness.manifest import ROOT, Bench, load_module
from portbench.tests import fixtures

PUBLISHED = {  # OpenAI CLIP's published sizes (clip/model.py, the HF config.json files)
    "clip_vit_b32": dict(embed_dim=512, image_resolution=224, vision_layers=12, vision_width=768,
                         vision_patch_size=32, vision_heads=12, context_length=77,
                         vocab_size=49408, transformer_width=512, transformer_heads=8,
                         transformer_layers=12),
    "clip_vit_l14": dict(embed_dim=768, image_resolution=224, vision_layers=24,
                         vision_width=1024, vision_patch_size=14, vision_heads=16,
                         context_length=77, vocab_size=49408, transformer_width=768,
                         transformer_heads=12, transformer_layers=12),
}


@pytest.fixture(scope="module")
def bench():
    return Bench(os.path.join(ROOT, "BENCHMARK.json"))


def test_manifest_form(bench):
    m = bench.m
    assert m["command"] == ["python3", "portbench/run.py"] and m["paths"] == ["portbench"]
    assert 1 <= m["run_seconds"] <= 51 and isinstance(m["run_seconds"], int)
    assert os.path.getsize(bench.path) <= 64 * 1024
    for e in m["end_to_end"]:
        assert 0.01 <= e["bound"] <= 0.25
    assert "setup_s" in [e["name"] for e in m["end_to_end"]]
    assert sum(w["chips"] == 4 for w in m["workloads"]) <= max(1, len(m["workloads"]) // 4)


@pytest.mark.parametrize("bad", [
    {"name": "has space"}, {"name": "a/b"}, {"unit": "tokens per second"}, {"better": "up"},
    {"source": "stopwatch"}, {"why_not": 1},
])
def test_manifest_refuses_bad_metric(bench, bad):
    m = json.loads(json.dumps(bench.m))
    m["end_to_end"][0].update(bad)
    with pytest.raises(manifest.ManifestError):
        manifest.check(m)


def test_every_named_file_is_found(bench):
    for w in bench.m["workloads"]:
        cell = bench.workload(w["name"])
        load_module("drivers", cell["driver"])
        cfg = bench.config(cell["config"])
        assert cfg["source"] == next(c["source"] for c in bench.m["configs"]
                                     if c["name"] == cell["config"])
        e2e = {e["name"] for e in bench.end_to_end(w["name"])}
        assert "setup_s" in e2e and cell["rate_metric"] in e2e and len(e2e) == 2
        layer = bench.per_layer(w["name"])
        assert layer and all(e["moves"] in e2e for e in layer)
        assert set(cell["limits"]) and all(v >= 0 for v in cell["limits"].values())
    for e in bench.m["per_layer"]:
        assert callable(load_module("metrics", e["name"]).read)
        assert set(e["workloads"]) <= {w["name"] for w in bench.m["workloads"]}


@pytest.mark.parametrize("name", sorted(PUBLISHED))
def test_configs_hold_published_widths(bench, name):
    from menghini_neurips23_tpu_torch.models.configs import get_arch

    cfg = bench.config(name)
    assert {k: cfg[k] for k in PUBLISHED[name]} == PUBLISHED[name]
    assert cfg["reduced"] == []
    arch = get_arch(cfg["arch"])
    assert {k: getattr(arch, k) for k in PUBLISHED[name]} == PUBLISHED[name]


def test_a_cell_defined_only_in_a_fixture_loads(tmp_path):
    b = Bench(fixtures.write_manifest(str(tmp_path)))
    for name in fixtures.CELLS:
        cell = b.workload(name)
        assert cell["config"] == "tiny" and b.config("tiny")["arch"] == "tiny-test"
        assert {e["name"] for e in b.per_layer(name)}
