"""Each mix run end to end on the CPU at a tiny size through the port's plain
paths, its result line in the form the benchmark's checks read; the cells are
added as a later change would add one (files and entries only)."""

from __future__ import annotations

import json

import pytest
import torch

from port_bench import run
from port_bench_tiny import make_root

SEED = 3_000_000_019          # more than 31 bits, as the checks' seeds are


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    torch.set_num_threads(1)
    return make_root(tmp_path_factory.mktemp("bench"))


def _run(root, capsys, workload, trace):
    got = run.main(["--workload", workload, "--seed", str(SEED), "--seconds",
                    "2", "--trace", str(trace)], root=root, device="cpu")
    out, err = capsys.readouterr()
    return got, out, err


@pytest.mark.parametrize("workload", ["train-tiny", "serve-tiny"])
@pytest.mark.parametrize("trace", [0, 1])
def test_result_line_has_the_checked_form(root, capsys, workload, trace):
    got, out, err = _run(root, capsys, workload, trace)
    line = json.loads(out.strip().splitlines()[-1])
    assert line == json.loads(json.dumps(got))
    assert list(line)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(line)
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] > 0
    spec = run.load_spec(root)
    want = {m["name"] for m in run.metrics_of(
        spec, workload, "per_layer" if trace else "end_to_end")}
    if trace:
        # no device on the CPU: a reader with nothing to read says nothing
        assert set(line["metrics"]) <= want
        assert line["device"]["window_s"] > 0
        assert len(line["breakdown"]["idle_gaps"]) <= 10
    else:
        assert set(line["metrics"]) == want
        assert all(m["value"] > 0 for m in line["metrics"].values())
    last = err.strip().splitlines()[-len(line["checks"]):]
    for (name, c), text in zip(line["checks"].items(), last):
        assert text == f"check {name} {c['value']!r} limit {c['limit']!r}"


def test_same_seed_same_inputs(root):
    from port_bench import scene
    cfg = json.loads((root / "port_bench/configs/tiny.json").read_text())
    a = scene.gaussians(cfg, 5, "cpu")
    b = scene.gaussians(cfg, 5, "cpu")
    c = scene.gaussians(cfg, 6, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["xyz"], c["xyz"])
    assert scene.seeds(SEED, 3) == scene.seeds(SEED, 3)
    assert len(set(scene.seeds(-SEED, 4))) == 4


def test_no_card_exits_nonzero(root, capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        run.main(["--workload", "train-tiny", "--seed", "1", "--seconds",
                  "1"], root=root)
    assert e.value.code != 0
    assert capsys.readouterr().out == ""


def test_metrics_of_follows_the_entries(root):
    spec = run.load_spec(root)
    e2e = {m["name"] for m in run.metrics_of(spec, "serve-tiny",
                                             "end_to_end")}
    assert e2e == {"frames_per_s", "setup_s"}
    layer = {m["name"] for m in run.metrics_of(spec, "train-tiny",
                                               "per_layer")}
    assert layer == {m["name"] for m in spec["per_layer"]
                     if m["name"].endswith(".train")}
