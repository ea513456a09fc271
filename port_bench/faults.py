"""Faults planted in the program's timed path, to show that the check
catches them: ``plant(name)`` patches the program for the duration of a
``with`` block. Used by the tests (at a tiny size on the CPU) and by
``control.py`` (at a cell's own size on the card).

- ``unchanged``: Adam returns the state it was given;
- ``half``: the loss of a view is the mean over its upper half only (half
  the batch's pixels left out);
- ``altered``: the render's red channel is offset by 0.01 where the
  compositor produces it.
"""

from __future__ import annotations

import contextlib

FAULTS = {"train": ("unchanged", "half", "altered"), "serve": ("altered",)}


@contextlib.contextmanager
def plant(name: str):
    from gslm_tpu_torch import renderer, train
    saved = []

    def patch(mod, attr, fn):
        saved.append((mod, attr, getattr(mod, attr)))
        setattr(mod, attr, fn)

    if name == "unchanged":
        patch(train, "adam_step", lambda params, grads, state, lrs,
              visible=None: (params, state))
    elif name == "half":
        loss = train.scalar_training_loss

        def half(params, cameras, bg, **kw):
            return loss(params, cameras.replace(
                heights=cameras.heights // 2), bg, **kw)
        patch(train, "scalar_training_loss", half)
    elif name == "altered":
        raster = renderer.rasterize_cuda

        def altered(*a, **kw):
            out = raster(*a, **kw)
            img = out["render"]
            out["render"] = img + img.new_tensor([0.01, 0.0, 0.0])[:, None,
                                                                   None]
            return out
        patch(renderer, "rasterize_cuda", altered)
    else:
        raise ValueError(f"no fault {name!r}")
    try:
        yield
    finally:
        for mod, attr, fn in reversed(saved):
            setattr(mod, attr, fn)
