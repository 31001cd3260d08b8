"""``BENCHMARK.json`` and the files the harness finds by its names: every
cell's configuration, traffic and limits, every per-layer metric's reader
(its layer, unit, ``moves`` and source as the entry states them); a metric
added as a new file and a new entry is found without an edit."""
import os
import re

from benchmark import harness

SPEC = harness.benchmark_spec()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_keys_names_and_files():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in SPEC[k]]
    assert all(NAME.match(n) for n in names) and len(names) == len(set(names))
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        cfg = harness.load_json(os.path.join(harness.ROOT, c["file"]))
        assert cfg["reduced"] == c["reduced"] and cfg["name"] == c["name"]
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] in (1, 4)
        assert len(w["why"]) <= 200
        harness.config_file(w["config"])
        traffic = harness.traffic_file(w["traffic"])
        assert os.path.exists(os.path.join(harness.HERE, "modes", f"{traffic['mode']}.py"))
        assert harness.limits_file(w["name"])


def test_bounds_and_the_check_budget():
    for m in SPEC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    r = SPEC["run_seconds"]
    assert isinstance(r, int) and 1 <= r <= 51
    runs = 2 + 14 * 24
    assert runs * (r + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_every_metric_has_its_reader():
    cells = {w["name"] for w in SPEC["workloads"]}
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    for m in SPEC["per_layer"]:
        mod = harness.load_module(os.path.join(harness.HERE, "metrics", f"{m['name']}.py"),
                                  "x")
        assert (mod.LAYER, mod.UNIT, mod.MOVES, mod.SOURCE) == (
            m["layer"], m["unit"], m["moves"], m["source"])
        for cell in m["workloads"]:
            assert cell in cells
            assert "workloads" not in e2e[m["moves"]] or cell in e2e[m["moves"]]["workloads"]


def test_a_new_metric_is_found_by_its_file(tmp_path, monkeypatch):
    (tmp_path / "metrics").mkdir()
    (tmp_path / "metrics" / "dummy.count.py").write_text(
        'LAYER = "dummy"\nUNIT = "1"\nMOVES = "setup_s"\nSOURCE = "program_counter"\n'
        'def read(r):\n    return r.get("dummy")\n')
    monkeypatch.setattr(harness, "HERE", str(tmp_path))
    spec = {"per_layer": [{"name": "dummy.count", "workloads": ["a"]},
                          {"name": "dummy.count", "workloads": ["b"]}]}
    readers = harness.metric_readers(spec, "a")
    assert list(readers) == ["dummy.count"]
    assert readers["dummy.count"].read({"dummy": 3.0}) == 3.0
    assert readers["dummy.count"].read({}) is None
    assert harness.metric_readers(spec, "c") == {}
    spec = {"per_layer": [{"name": "dummy.count"}]}
    assert list(harness.metric_readers(spec, "c")) == ["dummy.count"]


def test_a_new_data_layout_is_found_by_its_file(tmp_path, monkeypatch):
    from benchmark import data

    (tmp_path / "layouts").mkdir()
    (tmp_path / "layouts" / "dummy_grid.py").write_text(
        "import numpy as np\n"
        "def make(rng, total, layout):\n"
        "    n = layout['nodes']\n"
        "    x = rng.uniform(0, 1, (1, 1, n, 2)).astype(np.float32)\n"
        "    c = rng.standard_normal((total, 1, n, 1)).astype(np.float32)\n"
        "    return {'u': 2 * c, 'c': c, 'x': x}\n")
    monkeypatch.setattr(data, "HERE", str(tmp_path))
    a = data.make({"layout": "dummy_grid", "nodes": 5}, 3, 7)
    assert a["u"].shape == (3, 1, 5, 1) and a["x"].shape == (1, 1, 5, 2)
    assert (data.make({"layout": "dummy_grid", "nodes": 5}, 3, 7)["c"] == a["c"]).all()


def test_seeds_take_any_whole_number():
    for s in (0, 1, 2 ** 31 + 12345, 2 ** 40, -5):
        v = harness.seeds(s)
        assert all(0 <= x < 2 ** 31 for x in v.values())
    assert harness.seeds(7) == harness.seeds(7) != harness.seeds(8)


def test_statistics():
    assert harness.percentile(list(range(1, 101)), 95) == 95
