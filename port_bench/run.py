"""Run one cell of the benchmark once.

    python3 -m port_bench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout that holds ``BENCHMARK.json``. Everything is
found by name: the cell in ``BENCHMARK.json``, its configuration file, its
mix ``port_bench/mixes/<traffic>.json`` (whose ``kind`` names the module
of ``port_bench/kinds/`` that runs that kind of mix), and each per-layer
metric's reader ``port_bench/metrics/<metric>.py``, or the one file of its
base name before the suffix (``device_idle.py`` for ``device_idle.train``).

The run makes its inputs from the seed, sets up and warms up the program
(``setup_s``), measures for ``--seconds`` (``--trace 0``: the cell's
end-to-end metrics) or profiles the mix's ``trace_steps`` steps (``--trace
1``: its per-layer metrics), checks that no JAX module was loaded, frees the
program's state and compares what the timed path produced with the plain
reference. The last line of standard output is one JSON object; the
numbers compared, each beside its limit, are the last lines of standard
error and the result's last key.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
clock = time.perf_counter
FORBIDDEN = ("jax", "jaxlib", "flax", "gslm_tpu")


@dataclasses.dataclass
class Context:
    """What a mix's kind is handed: the cell's configuration and mix, the
    seed, the device, and whether the run is traced. ``mark`` ends a phase
    of set-up; the phases go to standard error."""

    cell: dict
    cfg: dict
    mix: dict
    seed: int
    device: object
    trace: bool
    phases: list = dataclasses.field(default_factory=list)

    def mark(self, name: str) -> None:
        if self.device.type == "cuda":
            import torch
            torch.cuda.synchronize()
        self.phases.append((name, time.perf_counter()))


def load_spec(root: Path) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def resolve(spec: dict, root: Path, name: str):
    """The cell ``name``, its configuration and its mix."""
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json "
                         f"(have {sorted(cells)})")
    cell = cells[name]
    conf = {c["name"]: c for c in spec["configs"]}[cell["config"]]
    cfg = json.loads((root / conf["file"]).read_text())
    mix = json.loads((root / "port_bench" / "mixes"
                      / f"{cell['traffic']}.json").read_text())
    return cell, cfg, mix


def metrics_of(spec: dict, cell: str, kind: str) -> list:
    """The ``end_to_end`` metrics this cell reports (those without a
    ``workloads`` list and those that list it), or the ``per_layer``
    metrics that list it."""
    if kind == "end_to_end":
        return [m for m in spec["end_to_end"]
                if cell in m.get("workloads", [cell])]
    return [m for m in spec["per_layer"] if cell in m["workloads"]]


def reader(root: Path, name: str):
    """The ``read(trace, work)`` of ``port_bench/metrics/<name>.py``, or
    where there is none, of the file of its base name before the first
    dot."""
    path = root / "port_bench" / "metrics" / f"{name}.py"
    if not path.exists():
        path = path.with_name(f"{name.split('.')[0]}.py")
    sp = importlib.util.spec_from_file_location(
        f"port_bench.metrics.{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(sp)
    sp.loader.exec_module(mod)
    return mod.read


def loaded_forbidden() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def fail(msg: str, code: int = 1):
    print(msg, file=sys.stderr)
    raise SystemExit(code)


def device_line(torch, count: int) -> dict:
    if torch.cuda.is_available():
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                "count": count,
                "memory_peak_bytes": int(torch.cuda.max_memory_allocated())}
    return {"platform": "cpu", "kind": "cpu", "count": count,
            "memory_peak_bytes": 0}


def main(argv=None, *, root: Path = ROOT, device: str | None = None) -> dict:
    """Run one cell; prints the result line and returns it. ``device``
    other than None (the tests: "cpu") skips the look for a card."""
    ap = argparse.ArgumentParser(prog="python3 -m port_bench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    spec = load_spec(root)
    cell, cfg, mix = resolve(spec, root, args.workload)
    phases = [("start", T_START)]
    import torch
    phases.append(("import torch", clock()))
    if device is None:
        if (not torch.cuda.is_available()
                or torch.cuda.device_count() < cell["chips"]):
            fail(f"{args.workload} needs {cell['chips']} CUDA device(s); "
                 f"torch sees {torch.cuda.device_count()}", 2)
        device = "cuda"
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.cuda.init()
        phases.append(("device", clock()))
    try:
        import gslm_tpu_torch  # noqa: F401
    except ImportError as e:
        fail(f"the program under test is missing: {e}")
    kind = importlib.import_module(f"port_bench.kinds.{mix['kind']}")
    ctx = Context(cell, cfg, mix, args.seed, torch.device(device),
                  bool(args.trace), phases)
    ctx.mark("import program")
    st = kind.setup(ctx)
    ctx.mark("end")
    setup_s = clock() - T_START
    print("setup phases (s): " + ", ".join(
        f"{n} {t - t_prev:.3f}" for (_, t_prev), (n, t) in
        zip(phases, phases[1:])), file=sys.stderr)
    box = {}
    if args.trace:
        from port_bench import trace as tr_mod
        steps = mix["trace_steps"]
        attempted, failed = kind.traced(
            st, steps, lambda: tr_mod.capture(box, steps))
        stats = {}
    else:
        stats, attempted, failed = kind.window(st, args.seconds, clock)
        print("window: " + ", ".join(f"{k} {v!r}" for k, v in
                                     stats.items()), file=sys.stderr)
    peak = device_line(torch, cell["chips"])
    found = loaded_forbidden()
    if found:
        fail(f"modules of JAX or the JAX package are loaded: {found}")
    kept = kind.release(st)
    del st
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()

    metrics = {}
    breakdown = None
    if args.trace:
        tr = box["trace"]
        work = kind.work(ctx, kept)
        for m in metrics_of(spec, args.workload, "per_layer"):
            v = reader(root, m["name"])(tr, work)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        print("device ops (s): " + ", ".join(
            f"{n} {t!r}" for n, t in tr_mod.device_ops(tr)[:25]),
            file=sys.stderr)
        peak["busy_s"] = tr.busy_s()
        peak["window_s"] = tr.window_s
        breakdown = {"device_ops": [list(x) for x in
                                    tr_mod.device_ops(tr)[:10]],
                     "idle_gaps": [list(x) for x in tr_mod.idle_gaps(tr)[:10]]}
    else:
        for m in metrics_of(spec, args.workload, "end_to_end"):
            if m["name"] == "setup_s":
                metrics["setup_s"] = {"value": setup_s, "unit": "s"}
            else:
                metrics[m["name"]] = {"value": stats[mix["end_to_end"]
                                                     [m["name"]]],
                                      "unit": m["unit"]}

    t_ref = clock()
    readings = kind.check(ctx, kept)
    print(f"phases (s): setup {setup_s:.3f}, reference check "
          f"{clock() - t_ref:.3f}, whole run {clock() - T_START:.3f}",
          file=sys.stderr)
    limits = mix["limits"]
    checks = {k: {"value": readings[k], "limit": limits[k]} for k in limits}
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    out = {"correct": correct, "attempted": attempted, "failed": failed,
           "metrics": metrics, "device": peak}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = checks
    for k, c in checks.items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    os.environ.setdefault("USE_FLAX", "0")
    # Python's bytecode is a compile cache like the kernels' libraries: kept
    # at a fixed path in the checkout, so that only a checkout's first run
    # compiles the modules it imports (torch's too), whatever
    # PYTHONDONTWRITEBYTECODE says
    sys.dont_write_bytecode = False
    sys.pycache_prefix = str(ROOT / "build" / "pycache")
    main()
