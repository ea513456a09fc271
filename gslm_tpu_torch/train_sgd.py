"""SGD-batch trainer (gslm_tpu/train_sgd.py): first-order steps over
strided multi-view windows.

Per iteration a random-stride (1..3) contiguous window of ``--num_images``
views is fit with one Adam step over one batched render (the reference's
train_sgd.py:71-215 loops ``loss.backward()`` per view). As in the JAX
package, per-view losses are averaged, not summed, and densification uses
the masked implementation.

Usage: python -m gslm_tpu_torch.train_sgd -s <dataset> -m <output>
       [--num_images N]
"""

from __future__ import annotations

import numpy as np


def main(argv=None):
    """The command line (``argv``, default ``sys.argv[1:]``). Returns
    ``training``'s ``(scene, params, aux, opt_state)``."""
    from gslm_tpu_torch.train import build_parser, training

    parser = build_parser()   # --num_images comes from the LM param group
    args = parser.parse_args(argv)
    args.save_iterations.append(args.iterations)
    args.sgd_batch = True
    print("Optimizing " + args.model_path
          + f" (SGD windows of {args.num_images})")
    out = training(args)
    print("\nTraining complete.")
    return out


def select_window(num_cams: int, num_images: int,
                  rng: np.random.Generator) -> list[int]:
    """Random-stride contiguous window (reference train_sgd.py:138-150)."""
    n = min(num_images, num_cams)
    stride = int(rng.integers(1, 4))
    hi = max(num_cams - n * stride, 1)
    start = int(rng.integers(0, hi))
    return [min(start + i * stride, num_cams - 1) for i in range(n)]


if __name__ == "__main__":
    main()
