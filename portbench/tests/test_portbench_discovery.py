"""Discovery by name: a configuration, a cell, a per-layer metric and a
kernel count added as files under new names, in a copy of the benchmark,
are found with no edit to a file that exists; an unknown name fails with a
message."""

import json
import subprocess
import sys
import time

import pytest

import pbtest_tiny
from portbench.harness import cell, discovery


def test_new_files_are_found_by_name(tmp_path):
    root = pbtest_tiny.tiny_root(tmp_path)
    before = {p: p.read_bytes() for p in root.rglob("*") if p.is_file()}
    cf = json.loads((root / "configs" / "tiny.json").read_text())
    cf["config"]["model"]["ngf"] = 24
    (root / "configs" / "new_config.json").write_text(json.dumps(cf))
    wl = json.loads((root / "workloads" / "tiny-sample.json").read_text())
    wl["config"] = "new_config"
    (root / "workloads" / "new-cell.json").write_text(json.dumps(wl))
    (root / "counts" / "new_kernel.py").write_text(
        'KERNELS = r"new_kernel"\nCALLS = "gn_fused"\n\n\n'
        'def work(call, dtype):\n    return 1.0, 2.0\n\n\n'
        'def least(call, dtype):\n    return 3.0\n')
    (root / "metrics" / "new_metric.sample.py").write_text(
        'UNIT = "things"\n\n\ndef read(run):\n'
        '    return 0.5 * run.count("new_kernel").least(None, run.dtype) '
        '* run.outcome.attempted / run.outcome.attempted\n')

    assert discovery.load_config("new_config", root)["config"]["model"]["ngf"] == 24
    assert discovery.load_workload("new-cell", root)["config"] == "new_config"
    assert discovery.load_count("new_kernel", root).least({}, "float32") == 3.0
    assert "new_metric.sample" in discovery.metric_readers(root)
    out = cell.run_cell("new-cell", pbtest_tiny.SEED, 0.1, True, "cpu", time.perf_counter(),
                        root=root)
    assert out["metrics"]["new_metric.sample"] == {"value": 1.5, "unit": "things"}
    assert out["correct"] is True
    assert all(p.read_bytes() == b for p, b in before.items())   # nothing edited


@pytest.mark.parametrize("load,name", [
    (discovery.load_workload, "no-such-cell"), (discovery.load_config, "no_such_config"),
    (discovery.load_mode, "no_such_mode"), (discovery.load_metric, "no_such.metric"),
    (discovery.load_count, "no_such_kernel"), (discovery.load_workload, "../configs/x"),
])
def test_unknown_names_fail_with_a_message(load, name):
    with pytest.raises(discovery.UnknownName, match="no |not a benchmark name"):
        load(name)


def test_the_command_names_an_unknown_cell(tmp_path):
    r = subprocess.run([sys.executable, str(pbtest_tiny.BENCH / "run.py"), "--workload",
                        "no-such-cell", "--seed", "1", "--seconds", "1", "--trace", "0"],
                       cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert r.returncode == 2 and r.stdout == ""
    assert "no workload 'no-such-cell'" in r.stderr and "big5-sample-b100" in r.stderr


def test_the_benchmark_file_matches_the_data_files():
    bench = json.loads((pbtest_tiny.REPO / "BENCHMARK.json").read_text())
    for c in bench["configs"]:
        f = json.loads((pbtest_tiny.REPO / c["file"]).read_text())
        assert f["name"] == c["name"] and f["source"] == c["source"]
        assert f["reduced"] == c["reduced"]
    readers = discovery.metric_readers()
    for m in bench["per_layer"]:
        assert readers[m["name"]].UNIT == m["unit"]
    for w in bench["workloads"]:
        wl = discovery.load_workload(w["name"])
        assert wl["config"] == w["config"] and wl["mode"] == w["traffic"].split("-")[0]
        assert wl["why"] == w["why"] and wl["chips"] == w["chips"]
        mode = discovery.load_mode(wl["mode"])
        for m in bench["end_to_end"]:
            if m["name"] != "setup_s" and w["name"] in m.get("workloads", [w["name"]]):
                assert mode.E2E[m["name"]] == m["unit"]
