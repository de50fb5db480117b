"""Every configuration, workload, traffic and metric file loads by the
name BENCHMARK.json gives it, and a further workload file is found without
a change to any file there."""

import json
import os
import shutil

import run

with open(os.path.join(run.ROOT, "BENCHMARK.json")) as f:
    BENCH = json.load(f)


def test_every_cell_loads_by_name():
    configs = {c["name"]: c for c in BENCH["configs"]}
    for w in BENCH["workloads"]:
        cell = run.load_cell(w["name"])
        assert cell["config"] == w["config"]
        assert cell["traffic_name"] == w["traffic"]
        assert cell["chips"] == w["chips"]
        assert cell["why"] == w["why"]
        path = os.path.join(run.ROOT, configs[w["config"]]["file"])
        with open(path) as f:
            assert json.load(f)["name"] == w["config"]
        assert cell["traffic"]["kind"] == cell["entry"]


def test_every_metric_has_a_reader_and_a_cell():
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["per_layer"]:
        assert callable(run.reader(m["name"]))
        assert set(m["workloads"]) <= cells
    for w in cells:
        e2e, layer = run.benchmark_metrics(w)
        names = {m["name"] for m in e2e}
        assert "setup_s" in names and len(names) >= 2
        assert layer


def test_a_fourth_workload_is_picked_up(tmp_path, monkeypatch):
    root = tmp_path / "repo"
    shutil.copytree(run.HERE, root / "benchmark",
                    ignore=shutil.ignore_patterns("_cache", "__pycache__"))
    bench = dict(BENCH)
    src = run.load_json("workloads", "mask_rcnn_coco.images.json")
    src["traffic"] = "images_burst"
    (root / "benchmark" / "workloads" / "mask_rcnn_coco.burst.json").write_text(
        json.dumps(src))
    traffic = run.load_json("traffic", "images.json")
    traffic["images"] = 8
    (root / "benchmark" / "traffic" / "images_burst.json").write_text(
        json.dumps(traffic))
    bench["workloads"] = BENCH["workloads"] + [dict(
        name="mask_rcnn_coco.burst", config="mask-rcnn-r50-fpn-coco",
        traffic="images_burst", chips=1, why=src["why"])]
    bench["end_to_end"] = [dict(m, workloads=m["workloads"] + [
        "mask_rcnn_coco.burst"]) if "mask_rcnn_coco.images" in
        m.get("workloads", []) else m for m in BENCH["end_to_end"]]
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    monkeypatch.setattr(run, "HERE", str(root / "benchmark"))
    monkeypatch.setattr(run, "ROOT", str(root))
    cell = run.load_cell("mask_rcnn_coco.burst")
    assert cell["traffic"]["images"] == 8
    e2e, layer = run.benchmark_metrics("mask_rcnn_coco.burst")
    assert {m["name"] for m in e2e} == {"images_per_s", "latency_p95_ms",
                                       "setup_s"}
    assert layer == []  # per-layer metrics name their cells
