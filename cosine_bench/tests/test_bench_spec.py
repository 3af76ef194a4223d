"""The harness is driven by data: a new configuration, traffic mix or
metric is new files and new BENCHMARK.json entries; and the committed
BENCHMARK.json keeps to the benchmark's contract."""
import json
import re
import shutil

from cosine_bench import spec
from tiny import DATA, ROOT, run

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def test_new_config_mix_and_metric_need_no_edit(tmp_path):
    """A copy of the tiny cell under new names, a new mix and a new
    reader, each a new file, run with the committed harness."""
    (tmp_path / "cosine_bench" / "tests" / "data").mkdir(parents=True)
    conf = json.loads((DATA / "tiny-moe.json").read_text())
    conf["name"] = "fresh"
    (tmp_path / "cosine_bench/tests/data/fresh.json").write_text(
        json.dumps(conf))
    mix = json.loads((DATA / "tiny4.json").read_text())
    mix["clients"] = 2
    (tmp_path / "fresh2.json").write_text(json.dumps(mix))
    reader = tmp_path / "metrics"
    reader.mkdir()
    (reader / "requests_done.py").write_text(
        "def read(run):\n"
        "    return sum(1 for s in run['sent'] if s.done is not None)\n")
    bench = {"configs": [{"name": "fresh",
                          "file": "cosine_bench/tests/data/fresh.json"}],
             "workloads": [{"name": "tiny.t4", "config": "fresh",
                            "traffic": "fresh2", "chips": 1}],
             "end_to_end": [{"name": "tokens_per_s", "unit": "tokens/s"},
                            {"name": "requests_done", "unit": "requests"}],
             "per_layer": []}
    orig = spec.reader
    try:
        spec.reader = lambda name: orig(
            name, reader if name == "requests_done" else spec.HERE / "metrics")
        res, _ = run(bench=bench, root=tmp_path, traffic_dir=tmp_path)
    finally:
        spec.reader = orig
    assert res["correct"]
    assert set(res["metrics"]) == {"tokens_per_s", "requests_done"}
    assert res["metrics"]["requests_done"]["unit"] == "requests"


def test_metrics_by_cell():
    bench = {"end_to_end": [{"name": "a", "unit": "s"},
                            {"name": "b", "unit": "s", "workloads": ["x"]}],
             "per_layer": [{"name": "c", "unit": "%", "workloads": ["y"]}]}
    assert spec.metrics(bench, "x", False) == [("a", "s"), ("b", "s")]
    assert spec.metrics(bench, "y", False) == [("a", "s")]
    assert spec.metrics(bench, "y", True) == [("c", "%")]


def test_committed_benchmark_keeps_the_contract():
    b = spec.load()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["command"][1].startswith(b["paths"][0] + "/")
    assert 1 <= b["run_seconds"] <= 51
    runs = 2 + 14 * 24
    assert runs * (b["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    configs = {c["name"]: c for c in b["configs"]}
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("cosine_bench/")
        assert (ROOT / c["file"]).is_file()
        conf = json.loads((ROOT / c["file"]).read_text())
        assert conf["reduced"] == c["reduced"]
        assert not any(k.endswith(("_dim", "_rank", "_size"))
                       for k in c["reduced"])
    cells = {w["name"]: w for w in b["workloads"]}
    assert {w["config"] for w in b["workloads"]} == set(configs)
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
        assert (spec.HERE / "traffic" / f"{w['traffic']}.json").is_file()
    e2e = {m["name"] for m in b["end_to_end"]}
    assert "setup_s" in e2e
    names = list(configs) + list(cells) + [m["name"] for m in
                                           b["end_to_end"] + b["per_layer"]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for m in b["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    layers = set()
    for m in b["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e and set(m["workloads"]) <= set(cells)
        for w in m["workloads"]:
            em = [e for e in b["end_to_end"] if e["name"] == m["moves"]][0]
            assert w in em.get("workloads", [w])
        layers.add(m["layer"])
        assert (spec.HERE / "metrics" / f"{m['name']}.py").is_file()
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert (spec.HERE / "metrics" / f"{m['name']}.py").is_file()
    for w in cells:
        assert any(w in m["workloads"] for m in b["per_layer"])
    assert len(json.dumps(b)) < 64 * 1024


def test_harness_runs_from_its_files_alone(tmp_path):
    """Without the program beside it the command fails and prints no
    result (here it also finds no CUDA device)."""
    import subprocess
    import sys
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "cosine_bench", tmp_path / "cosine_bench")
    res = subprocess.run(
        [sys.executable, "cosine_bench/run.py", "--workload",
         spec.load()["workloads"][0]["name"], "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=tmp_path, capture_output=True, text=True,
        timeout=300)
    assert res.returncode != 0
    assert not res.stdout.strip()
