"""The benchmark's files: every name BENCHMARK.json uses finds its file, the
names and units keep to their characters, and a cell added as files alone
is found without an edit."""

import json
import re
import shutil

import pytest

from port_bench import harness

UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def spec():
    return harness.benchmark_spec()


def test_top_level_keys():
    assert set(spec()) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert spec()["paths"] == ["port_bench"]
    assert 1 <= spec()["run_seconds"] <= 51


@pytest.mark.parametrize("kind", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_and_units(kind):
    names = [e["name"] for e in spec()[kind]]
    assert len(names) == len(set(names))
    for e in spec()[kind]:
        assert harness.NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")
        for key in ("why", "layer", "source"):
            if key in e:
                assert 1 <= len(e[key]) <= 200 and "\n" not in e[key] and "\t" not in e[key]


@pytest.mark.parametrize("cell", [w["name"] for w in harness.benchmark_spec()["workloads"]])
def test_every_cell_finds_its_files(cell):
    w = harness.cell_spec(cell)["cell"]
    cfg = harness.load_json("configs", w["config"])
    assert cfg["name"] == w["config"] and cfg["arch"] in ("resnet50", "eca_nfnet_l0")
    listed = next(c for c in spec()["configs"] if c["name"] == w["config"])
    assert listed["file"] == f"port_bench/configs/{w['config']}.json"
    assert listed["reduced"] == cfg["reduced"] and listed["source"] == cfg["source"]
    traffic = harness.load_json("traffic", w["traffic"])
    assert (harness.BENCH / "drivers" / f"{traffic['driver']}.py").exists()
    assert harness.load_json("limits", cell)
    assert harness.cell_metrics(spec(), cell, "end_to_end")
    assert harness.cell_metrics(spec(), cell, "per_layer")


@pytest.mark.parametrize("metric", [m["name"] for m in harness.benchmark_spec()["per_layer"]])
def test_every_metric_has_a_reader_that_reads_nothing_from_nothing(metric):
    m = next(m for m in spec()["per_layer"] if m["name"] == metric)
    assert m["moves"] in {e["name"] for e in spec()["end_to_end"]}
    moved = next(e for e in spec()["end_to_end"] if e["name"] == m["moves"])
    for cell in m.get("workloads", []):
        assert "workloads" not in moved or cell in moved["workloads"], (metric, cell)
    assert harness.metric_reader(metric)({}) is None


def test_a_cell_added_as_files_alone_is_found(tmp_path, monkeypatch):
    root = tmp_path / "checkout"
    bench = root / "port_bench"
    shutil.copytree(harness.BENCH, bench, ignore=shutil.ignore_patterns("__pycache__"))
    b = spec()
    b["workloads"].append({"name": "r50.newmix", "config": "r50", "traffic": "newmix", "chips": 1, "why": "test"})
    b["per_layer"].append({"name": "new_metric", "unit": "ms", "better": "lower", "source": "device_trace",
                           "layer": "device", "moves": "train_img_per_s", "workloads": ["r50.newmix"]})
    b["end_to_end"][0]["workloads"].append("r50.newmix")
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    (bench / "traffic" / "newmix.json").write_text(json.dumps({"driver": "train", "feed": "host", "images": 512,
                                                               "check_steps": 3, "warm_steps": 3, "trace_steps": 4}))
    (bench / "limits" / "r50.newmix.json").write_text(json.dumps({"loss_gap": 0.1}))
    (bench / "metrics" / "new_metric.py").write_text("def read(s):\n    return s.get('x')\n")
    monkeypatch.setattr(harness, "ROOT", root)
    monkeypatch.setattr(harness, "BENCH", bench)
    found = harness.cell_spec("r50.newmix")
    assert harness.load_json("traffic", found["cell"]["traffic"])["feed"] == "host"
    names = [m["name"] for m in harness.cell_metrics(found["spec"], "r50.newmix", "per_layer")]
    assert names == ["new_metric"]
    assert harness.metric_reader("new_metric")({"x": 2.5}) == 2.5


def test_names_with_slashes_or_spaces_are_refused():
    for bad in ("../x", "a b", "a/b", ""):
        with pytest.raises(ValueError):
            harness.check_name(bad)
