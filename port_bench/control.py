"""The readings that set a cell's limits, on the card at the cell's own
size (the benchmark's own runs never run this):

    python3 -m port_bench.control --workload <cell> --seeds 11,12,13 \
        [--fault <name>] [--seconds 5]

Without ``--fault``: the control, the plain reference computed with every
stage stored in bfloat16 put in the program's place, against the float32
reference. With ``--fault``: a short run of the program with that fault
(``faults.py``) planted in its timed path. One JSON line per seed.
"""

from __future__ import annotations

import argparse
import importlib
import json

import torch

from port_bench import run
from port_bench.reference.render import Precision

BF16 = Precision(torch.bfloat16)


def control_readings(ctx) -> dict:
    """The bfloat16 reference's readings against the float32 one, on the
    inputs a run of this seed checks."""
    kind = importlib.import_module(f"port_bench.kinds.{ctx.mix['kind']}")
    if ctx.mix["kind"] == "train":
        from port_bench.kinds.train import ViewOrder, _inputs
        _, _, s_order, cams = _inputs(ctx)
        order = ViewOrder(len(cams), s_order)
        views = [order.next() for _ in range(ctx.mix["checked_steps"])]
        return kind.readings(kind.follow(ctx, views),
                               kind.follow(ctx, views, BF16))
    import numpy as np
    _, _, cams, start = kind._inputs(ctx)
    poses = [(start + i) % len(cams) for i in kind.checked(ctx)]
    ref = kind.reference_frames(ctx, poses)
    low = kind.reference_frames(ctx, poses, BF16)
    served = [a.astype(np.uint8).transpose(1, 2, 0) for a in low]
    return kind.readings(ref, low, served)


def main(argv=None, *, root=run.ROOT, device: str | None = None) -> list:
    ap = argparse.ArgumentParser(prog="python3 -m port_bench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--fault", default="")
    ap.add_argument("--seconds", type=float, default=5.0)
    args = ap.parse_args(argv)
    out = []
    for seed in (int(s) for s in args.seeds.split(",")):
        if args.fault:
            from port_bench.faults import plant
            with plant(args.fault):
                got = run.main(["--workload", args.workload, "--seed",
                                str(seed), "--seconds", str(args.seconds)],
                               root=root, device=device)
            line = {k: v["value"] for k, v in got["checks"].items()}
        else:
            spec = run.load_spec(root)
            cell, cfg, mix = run.resolve(spec, root, args.workload)
            dev = device or "cuda"
            if dev == "cuda":
                torch.backends.cuda.matmul.allow_tf32 = False
                torch.backends.cudnn.allow_tf32 = False
            line = control_readings(run.Context(cell, cfg, mix, seed,
                                                torch.device(dev), False))
        line = {"workload": args.workload, "seed": seed,
                "fault": args.fault or "control (bfloat16 reference)"} | line
        print(json.dumps(line), flush=True)
        out.append(line)
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
    return out


if __name__ == "__main__":
    main()
