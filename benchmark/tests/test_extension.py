"""A later configuration, traffic mix or per-layer metric is new files and new
BENCHMARK.json entries alone: a copy of the benchmark gains all three, and
they resolve by name with no existing file edited."""

import json
import shutil

from benchmark import harness


def test_new_config_mix_and_metric_resolve_by_name(tmp_path):
    here = tmp_path / "benchmark"
    shutil.copytree(harness.HERE, here, ignore=shutil.ignore_patterns("__pycache__"))
    before = {p.relative_to(here): p.read_bytes() for p in here.rglob("*") if p.is_file()}
    manifest = harness.load_manifest()
    (here / "configs" / "exact-rbf-n20k.json").write_text(json.dumps(
        {**harness.read_json("configs", "exact-rbf-n100k"), "name": "exact-rbf-n20k", "n": 20000}))
    (here / "traffic" / "love-small.json").write_text(json.dumps(
        {"loop": "serve", "batch_sizes": [256, 512], "kept_per_size": 1, "kept_within": 4}))
    (here / "metrics" / "batches.serve.py").write_text(
        "def read(trace):\n    return float(len(trace.counters['batches']))\n")
    (here / "limits" / "exact-rbf-n20k.love-small.json").write_text(json.dumps({"mean": 1e-5}))
    manifest["configs"].append({"name": "exact-rbf-n20k", "source": "https://arxiv.org/abs/1809.11165",
                                "file": "benchmark/configs/exact-rbf-n20k.json", "reduced": ["n"], "why": "x"})
    manifest["workloads"].append({"name": "exact-rbf-n20k.love-small", "config": "exact-rbf-n20k",
                                  "traffic": "love-small", "chips": 1, "why": "x"})
    manifest["per_layer"].append({"name": "batches.serve", "unit": "batches", "better": "higher",
                                  "source": "program_counter", "layer": "models", "moves": "query_points_per_s",
                                  "workloads": ["exact-rbf-n20k.love-small"]})
    cell = harness.resolve(manifest, "exact-rbf-n20k.love-small", here)
    assert cell.config["n"] == 20000 and cell.traffic["batch_sizes"] == [256, 512]
    assert cell.limits == {"mean": 1e-5}
    assert [m["name"] for m in cell.per_layer] == ["batches.serve"]
    reader = harness.load_module("metrics", "batches.serve", here)

    class T:
        counters = {"batches": [256, 512, 256]}

    assert reader.read(T) == 3.0
    after = {p.relative_to(here): p.read_bytes() for p in here.rglob("*") if p.is_file() and "__pycache__" not in str(p)}
    assert all(after[k] == v for k, v in before.items())
