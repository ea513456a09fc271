"""A throwaway benchmark root for the CPU tests: the real mixes and
metrics at a tiny configuration, laid out as a later change would add a
cell (a configuration file, a mix file and entries in ``BENCHMARK.json``),
with no edit to an existing file."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]

TINY = {
    "name": "tiny", "num_gaussians": 2000, "sh_degree": 3, "width": 64,
    "height": 48, "train_views": 6, "dtype": "float32", "tf32": False,
    "scene_law": {"spread": 1.5, "log_scale": [-4.0, -2.5],
                  "opacity_logit": [-1.0, 2.0], "dc_std": 0.5,
                  "rest_std": 0.05},
    "camera_law": {"radius": 4.0, "elevation": 0.3, "fov_deg": 60.0},
    "target_law": {"waves": 4}, "reduced": [], "assumed": {}}


def make_root(tmp: Path, mix_edits: dict | None = None) -> Path:
    """``tmp`` laid out as a checkout holding the tiny cells
    ``train-tiny`` and ``serve-tiny`` beside the real ones; ``mix_edits``
    {traffic: {key: value}} changes a copied mix."""
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    (tmp / "port_bench").mkdir(parents=True, exist_ok=True)
    for d in ("mixes", "metrics", "configs"):
        shutil.copytree(REPO / "port_bench" / d, tmp / "port_bench" / d,
                        dirs_exist_ok=True)
    (tmp / "port_bench" / "configs" / "tiny.json").write_text(json.dumps(TINY))
    spec["configs"].append({"name": "tiny", "source": "tests",
                            "file": "port_bench/configs/tiny.json",
                            "reduced": [], "why": "CPU tests"})
    for mix in ("train", "serve"):
        m = json.loads((REPO / "port_bench" / "mixes" / f"{mix}.json")
                       .read_text())
        m.update({"warmup_steps": 4, "probe_views": 2, "trace_steps": 3,
                  "warmup_frames": 2, "check_among": 3, "checked_frames": 2})
        if mix == "train":
            # 2,000 Gaussians sum far fewer terms into each gradient: sound
            # tiny runs read grad_gap up to ~4e-5 on the CPU (the cell's own
            # runs on the card under 1e-6), so the tiny cell allows 1e-3
            m["limits"] = dict(m["limits"], grad_gap=1e-3)
        m.update((mix_edits or {}).get(mix, {}))
        (tmp / "port_bench" / "mixes" / f"{mix}-tiny.json").write_text(
            json.dumps(m))
        name = f"{mix}-tiny"
        spec["workloads"].append({"name": name, "config": "tiny",
                                  "traffic": name, "chips": 1, "why": "tests"})
        real = f"{mix}-mip360-3m"
        for m_ in spec["end_to_end"] + spec["per_layer"]:
            if real in m_.get("workloads", []):
                m_["workloads"].append(name)
    (tmp / "BENCHMARK.json").write_text(json.dumps(spec))
    return tmp
