"""What the benchmark may import, and that its pieces are found by name."""

import ast
import json
import os
import shutil

import pytest

from perfbench.harness.bench import Bench

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(HERE)
FORBIDDEN = {"jax", "jaxlib", "flax", "eeg2video_tpu"}


def _sources(top):
    for d, _, files in os.walk(top):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def _imports(path):
    """Top-level names of every absolute import in the file (whole names:
    eeg2video_tpu_torch is not eeg2video_tpu)."""
    with open(path) as f:
        tree = ast.parse(f.read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            names.add(str(node.args[0].value).split(".")[0])
    return names


@pytest.mark.parametrize("path", sorted(_sources(HERE)), ids=lambda p: os.path.relpath(p, HERE))
def test_nothing_imports_jax_or_the_jax_package(path):
    assert not _imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted(_sources(os.path.join(HERE, "reference"))),
                         ids=os.path.basename)
def test_the_reference_imports_nothing_of_the_program(path):
    names = _imports(path)
    assert "eeg2video_tpu_torch" not in names
    assert names <= {"__future__", "contextlib", "hashlib", "math", "numpy", "torch"}


def test_the_whole_name_is_compared():
    import importlib.util

    spec = importlib.util.spec_from_file_location("perfbench_run", os.path.join(HERE, "run.py"))
    run = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(run)
    import sys

    sys.modules["eeg2video_tpu_torch_probe"] = sys
    try:
        assert "eeg2video_tpu" not in run.forbidden_modules()
    finally:
        del sys.modules["eeg2video_tpu_torch_probe"]


def test_every_entry_has_its_files():
    bench = Bench(REPO)
    spec = bench.spec
    for c in spec["configs"]:
        assert os.path.exists(os.path.join(REPO, c["file"]))
    for cell in spec["workloads"]:
        wl = bench.workload(cell["name"])
        assert hasattr(bench.traffic(wl["traffic"]), "run")
        assert bench.end_to_end(cell["name"]) and bench.per_layer(cell["name"])
    for m in spec["per_layer"]:
        mod = bench.metric(m["name"])
        assert (mod.LAYER, mod.MOVES) == (m["layer"], m["moves"])


NEW_METRIC = '''LAYER = "server"
MOVES = "clips_per_s"


def read(run):
    return 42.0
'''


def test_a_new_metric_and_cell_are_found_without_editing_a_file(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(HERE, root / "perfbench", ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: open(p, "rb").read() for p in _sources(root / "perfbench")}
    spec = json.loads(open(os.path.join(REPO, "BENCHMARK.json")).read())
    old = spec["workloads"][0]
    spec["workloads"].append(dict(old, name="e2v-serve-new", traffic="e2v-serve-new"))
    spec["per_layer"].append({"name": "answer_ms.serve", "unit": "ms", "better": "lower",
                              "source": "program_span", "layer": "server",
                              "moves": "clips_per_s", "workloads": ["e2v-serve-new"]})
    for m in spec["end_to_end"]:
        if old["name"] in m.get("workloads", []):
            m["workloads"].append("e2v-serve-new")
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    (root / "perfbench" / "metrics" / "answer_ms.serve.py").write_text(NEW_METRIC)
    cell = json.loads((root / "perfbench" / "workloads" / f"{old['name']}.json").read_text())
    cell["params"]["clients"] = 16
    (root / "perfbench" / "workloads" / "e2v-serve-new.json").write_text(json.dumps(cell))

    bench = Bench(str(root))
    assert bench.cell("e2v-serve-new")["config"] == old["config"]
    assert bench.workload("e2v-serve-new")["params"]["clients"] == 16
    assert bench.traffic(bench.workload("e2v-serve-new")["traffic"]).run
    names = [m["name"] for m in bench.per_layer("e2v-serve-new")]
    assert names == ["answer_ms.serve"]
    assert bench.metric("answer_ms.serve").read(None) == 42.0
    assert "answer_ms.serve" not in [m["name"] for m in bench.per_layer(old["name"])]
    assert {m["name"] for m in bench.end_to_end("e2v-serve-new")} >= {"clips_per_s", "setup_s"}
    for p, data in before.items():
        assert open(p, "rb").read() == data
