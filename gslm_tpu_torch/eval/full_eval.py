"""The full benchmark: train → render → metrics over the standard scenes
(gslm_tpu/eval/full_eval.py, the reference's full_eval.py:16-112).

The 9 Mip-NeRF 360 scenes (outdoor at images_4, indoor at images_2), 2
Tanks&Temples and 2 DeepBlending scenes, with skip flags and per-scene
training time written to the output root. Each scene runs the port's
command lines as subprocesses, on the card.

Usage: python -m gslm_tpu_torch.eval.full_eval -m360 <mipnerf360>
       -tat <t&t> -db <deepblending> [--output_path out] [--skip_training]
"""

from __future__ import annotations

import os
import subprocess
import sys
import time
from argparse import ArgumentParser

MIPNERF360_OUTDOOR = ["bicycle", "flowers", "garden", "stump", "treehill"]
MIPNERF360_INDOOR = ["room", "counter", "kitchen", "bonsai"]
TANKS_AND_TEMPLES = ["truck", "train"]
DEEP_BLENDING = ["drjohnson", "playroom"]


def run(cmd: list[str]):
    print("+", " ".join(cmd))
    subprocess.run(cmd, check=True)


def main(argv=None):
    parser = ArgumentParser(description="Full evaluation over all scenes")
    parser.add_argument("--output_path", default="./eval")
    parser.add_argument("--mipnerf360", "-m360", default="")
    parser.add_argument("--tanksandtemples", "-tat", default="")
    parser.add_argument("--deepblending", "-db", default="")
    parser.add_argument("--skip_training", action="store_true")
    parser.add_argument("--skip_rendering", action="store_true")
    parser.add_argument("--skip_metrics", action="store_true")
    parser.add_argument("--use_lm", action="store_true",
                        help="train with the two-phase LM trainer")
    parser.add_argument("--extra_train_args", default="",
                        help="extra flags passed to the trainer")
    args = parser.parse_args(argv)

    scenes = []   # (source, name, images_flag)
    for s in MIPNERF360_OUTDOOR:
        if args.mipnerf360:
            scenes.append((os.path.join(args.mipnerf360, s), s, "images_4"))
    for s in MIPNERF360_INDOOR:
        if args.mipnerf360:
            scenes.append((os.path.join(args.mipnerf360, s), s, "images_2"))
    for s in TANKS_AND_TEMPLES:
        if args.tanksandtemples:
            scenes.append((os.path.join(args.tanksandtemples, s), s, None))
    for s in DEEP_BLENDING:
        if args.deepblending:
            scenes.append((os.path.join(args.deepblending, s), s, None))
    if not scenes:
        print("No dataset roots given (-m360/-tat/-db); nothing to do.")
        return

    os.makedirs(args.output_path, exist_ok=True)
    trainer = "gslm_tpu_torch.train_lm" if args.use_lm \
        else "gslm_tpu_torch.train"
    timing_path = os.path.join(args.output_path, "timing.txt")

    for source, name, images in scenes:
        out = os.path.join(args.output_path, name)
        if not args.skip_training:
            cmd = [sys.executable, "-m", trainer, "-s", source, "-m", out,
                   "--eval", "--quiet"]
            if images:
                cmd += ["-i", images]
            if args.extra_train_args:
                cmd += args.extra_train_args.split()
            t0 = time.time()
            run(cmd)
            with open(timing_path, "a") as f:
                f.write(f"{name}: {(time.time() - t0) / 60.0:.2f} minutes\n")
        if not args.skip_rendering:
            run([sys.executable, "-m", "gslm_tpu_torch.eval.render_sets",
                 "-m", out, "--iteration", "30000", "--skip_train"])
    if not args.skip_metrics:
        run([sys.executable, "-m", "gslm_tpu_torch.eval.metrics", "-m"]
            + [os.path.join(args.output_path, name) for _, name, _ in scenes])


if __name__ == "__main__":
    main()
