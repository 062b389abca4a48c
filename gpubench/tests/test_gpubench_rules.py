"""The benchmark's own rules, checked on the CPU: what it may import and
read, that ``BENCHMARK.json`` names only files that exist, and that the
timed path refuses to run without a card."""
import ast
import json
import os
import re
import subprocess
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
FOREIGN = {"jax", "jaxlib", "flax", "rodio_tpu"}


def sources(sub=""):
    top = os.path.join(BENCH, sub)
    for d, _, names in os.walk(top):
        for n in names:
            if n.endswith(".py"):
                yield os.path.join(d, n)


def imported(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module.split(".")[0]


def test_no_module_imports_jax_or_the_jax_package():
    found = {p: sorted(set(imported(p)) & FOREIGN) for p in sources()}
    assert not {p: f for p, f in found.items() if f}


def test_the_reference_imports_nothing_of_the_port():
    found = {p: "rodio_tpu_torch" in set(imported(p)) for p in sources("reference")}
    assert found and not any(found.values())


def test_nothing_reads_the_repository_outside_its_folder():
    pattern = re.compile(r"""["'](?:\.\./)*(benches|bench\.py|tools|tests)(/|["'])""")
    hits = [p for p in sources() if "tests" not in os.path.relpath(p, BENCH).split(os.sep)
            and pattern.search(open(p).read())]
    assert not hits


def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_every_name_in_benchmark_json_has_its_files():
    b = bench()
    assert b["command"][:2] == ["python3", "gpubench/run.py"]
    for c in b["configs"]:
        stem = os.path.splitext(os.path.basename(c["file"]))[0]
        assert stem == c["name"]
        for f in (c["file"], f"gpubench/configs/{stem}.py", f"gpubench/reference/{stem}.py"):
            assert os.path.isfile(os.path.join(ROOT, f)), f
    for w in b["workloads"]:
        mix = json.load(open(os.path.join(BENCH, "traffic", w["traffic"] + ".json")))
        assert os.path.isfile(os.path.join(BENCH, "generators", mix["generator"] + ".py"))
        assert os.path.isfile(os.path.join(BENCH, "limits", w["name"] + ".json"))
        assert w["chips"] == 1
    e2e = {m["name"] for m in b["end_to_end"]}
    for m in b["per_layer"]:
        assert os.path.isfile(os.path.join(BENCH, "metrics", m["name"] + ".py"))
        assert m["moves"] in e2e
        assert m["workloads"], m["name"]  # the harness reads a per-layer metric's cells there


def test_every_cell_reports_setup_another_end_to_end_metric_and_a_per_layer_one():
    sys.path.insert(0, ROOT)
    from gpubench import harness

    b = bench()
    for w in b["workloads"]:
        e2e = {m["name"] for m in harness.cell_metrics(b, w["name"], False)}
        assert "setup_s" in e2e and len(e2e) >= 2, w["name"]
        assert harness.cell_metrics(b, w["name"], True), w["name"]
        for m in b["per_layer"]:
            if w["name"] in m["workloads"]:
                assert m["moves"] in e2e


@pytest.mark.parametrize("name", ["c5_render_jobs", "c2_file_render"])
def test_the_timed_path_refuses_to_run_without_a_card(name):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run(
        [sys.executable, "gpubench/run.py", "--workload", name, "--seed", "3000000000",
         "--seconds", "1", "--trace", "0"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert "{" not in proc.stdout
    assert "CUDA device" in proc.stderr
