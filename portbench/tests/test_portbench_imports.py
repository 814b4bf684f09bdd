"""The import guard: nothing the benchmark loads is JAX, its libraries or the
JAX package (top-level names compared whole), the reference loads nothing
of the port, and a run that finds no card fails without a result."""

import ast
import os
import subprocess
import sys
import textwrap

import pytest

import pbtest_tiny
from portbench.harness import cell

ENV = dict(os.environ, OMP_NUM_THREADS="2", CUDA_VISIBLE_DEVICES="")


def _python(code, tmp_path, timeout=300):
    return subprocess.run([sys.executable, "-c", textwrap.dedent(code)], cwd=tmp_path,
                          env=ENV, capture_output=True, text=True, timeout=timeout)


def test_cpu_rehearsal_of_each_mode_loads_no_jax(tmp_path):
    root = pbtest_tiny.tiny_root(tmp_path)
    r = _python(f"""
        import sys, time
        sys.path.insert(0, {str(pbtest_tiny.REPO)!r})
        import torch
        torch.set_num_threads(2)
        from portbench.harness import cell
        for name in ("tiny-sample", "tiny-train", "tiny-train-loader"):
            out = cell.run_cell(name, {pbtest_tiny.SEED}, 0.2, False, "cpu",
                                time.perf_counter(), root={str(root)!r})
            assert out["attempted"] > 0, out
        print("FOUND", cell.forbidden_modules(),
              sorted(m for m in sys.modules if m.split(".")[0] == "mcvd_tpu_torch")[:1])
        """, tmp_path)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "FOUND [] ['mcvd_tpu_torch']" in r.stdout, r.stdout[-2000:]


def test_reference_loads_nothing_of_the_port(tmp_path):
    r = _python(f"""
        import sys
        sys.path.insert(0, {str(pbtest_tiny.REPO)!r})
        import portbench.reference, portbench.counts.model_forward
        print("PORT", sorted({{m.split(".")[0] for m in sys.modules}} &
                             {{"mcvd_tpu_torch", "mcvd_tpu", "jax", "flax"}}))
        """, tmp_path)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "PORT []" in r.stdout


def test_reference_sources_import_torch_and_numpy_only():
    for path in sorted((pbtest_tiny.BENCH / "reference").glob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or "."] if node.level == 0 else []
            else:
                continue
            for n in names:
                assert n.split(".")[0] in {"torch", "numpy", "math", "typing", "__future__"}, \
                    f"{path.name} imports {n}"


def test_forbidden_names_are_compared_whole(monkeypatch):
    for name in ("mcvd_tpu_torch.ops", "jaxtyping", "flaxy", "optaxx"):
        monkeypatch.setitem(sys.modules, name, sys)
    assert cell.forbidden_modules() == [] or "jax" in sys.modules
    monkeypatch.setitem(sys.modules, "mcvd_tpu.models", sys)
    assert "mcvd_tpu" in cell.forbidden_modules()


@pytest.mark.parametrize("cell_name", ["big5-sample-b100", "big5-train-b64"])
def test_a_run_without_a_card_fails_with_no_result(tmp_path, cell_name):
    r = subprocess.run([sys.executable, str(pbtest_tiny.BENCH / "run.py"), "--workload",
                        cell_name, "--seed", str(pbtest_tiny.SEED), "--seconds", "1",
                        "--trace", "0"], cwd=tmp_path, env=ENV, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode != 0
    assert r.stdout.strip() == ""
    assert "CUDA device" in r.stderr
