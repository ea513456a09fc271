"""Nothing the benchmark runs loads JAX or the JAX package, and the
reference and the readers load nothing of the program: top-level module
names compared whole (the program's name begins with the JAX package's)."""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
TESTS = Path(__file__).resolve().parent

RUN_ALL = """
import json, sys, tempfile
from pathlib import Path
sys.path[:0] = [{repo!r}, {tests!r}]
import torch
torch.set_num_threads(1)
import port_bench_tiny
from port_bench import run, control, faults, program
from port_bench.kinds import train, serve
with tempfile.TemporaryDirectory() as tmp:
    root = port_bench_tiny.make_root(Path(tmp))
    spec = run.load_spec(root)
    for m in spec["per_layer"]:
        run.reader(root, m["name"])
    for w in ("train-tiny", "serve-tiny"):
        for t in ("0", "1"):
            run.main(["--workload", w, "--seed", "5", "--seconds", "1",
                      "--trace", t], root=root, device="cpu")
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""

YARDSTICK = """
import json, sys
sys.path[:0] = [{repo!r}]
from port_bench import run, costs, trace, work, scene
from port_bench.reference import render, train
for p in sorted(Path_(r"{repo}/port_bench/metrics").glob("*.py")):
    run.reader(Path_(r"{repo}"), p.stem)
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
""".replace("Path_", "__import__('pathlib').Path")


def _top_level(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=REPO)
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax():
    names = _top_level(RUN_ALL.format(repo=str(REPO), tests=str(TESTS)))
    assert "gslm_tpu_torch" in names and "port_bench" in names
    assert not names & {"jax", "jaxlib", "flax", "gslm_tpu"}


def test_the_yardstick_loads_no_program():
    names = _top_level(YARDSTICK.format(repo=str(REPO)))
    assert "port_bench" in names
    assert not names & {"gslm_tpu_torch", "gslm_tpu", "jax", "jaxlib",
                        "flax"}


def test_forbidden_names_are_compared_whole(monkeypatch):
    from port_bench import run
    monkeypatch.setitem(sys.modules, "gslm_tpu_torch_fake", sys)
    assert "gslm_tpu_torch_fake" not in run.loaded_forbidden()
    monkeypatch.setitem(sys.modules, "jaxlib.fake", sys)
    assert "jaxlib" in run.loaded_forbidden()
