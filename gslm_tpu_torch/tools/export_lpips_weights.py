"""Export LPIPS(VGG16) weights to the ``.npz`` that ``eval/lpips.py`` of
either package loads (gslm_tpu/tools/export_lpips_weights.py): keys
``conv<i>_W`` (HWIO) and ``conv<i>_b`` for the 13 convolutions,
``lin<j>_W`` for the 5 per-channel heads.

It needs a machine with network access and ``torchvision``: the VGG16
backbone is torchvision's ImageNet weights, the heads the state dict of
richzhang/PerceptualSimilarity's released v0.1 ``vgg.pth``. Point
``GSLM_LPIPS_WEIGHTS`` at the output (or put it at
``gslm_tpu_torch/eval/lpips_vgg16.npz``):

    python -m gslm_tpu_torch.tools.export_lpips_weights lpips_vgg16.npz
"""

from __future__ import annotations

import sys

import numpy as np

LIN_URL = ("https://raw.githubusercontent.com/richzhang/PerceptualSimilarity"
           "/master/lpips/weights/v0.1/vgg.pth")


def main(out_path: str = "lpips_vgg16.npz"):
    import torch
    import torch.hub
    import torchvision

    vgg = torchvision.models.vgg16(
        weights=torchvision.models.VGG16_Weights.IMAGENET1K_V1).features
    arrays = {}
    i = 0
    for layer in vgg:
        if isinstance(layer, torch.nn.Conv2d):
            # OIHW → HWIO, the layout the npz keeps
            arrays[f"conv{i}_W"] = (
                layer.weight.detach().cpu().numpy().transpose(2, 3, 1, 0))
            arrays[f"conv{i}_b"] = layer.bias.detach().cpu().numpy()
            i += 1
    if i != 13:
        raise RuntimeError(f"expected 13 VGG16 convs, got {i}")

    state = torch.hub.load_state_dict_from_url(
        LIN_URL, map_location="cpu", progress=True)
    for j in range(5):
        w = state[f"lin{j}.model.1.weight"]      # (1, C, 1, 1)
        arrays[f"lin{j}_W"] = w.detach().cpu().numpy().reshape(-1)

    np.savez(out_path, **arrays)
    print(f"wrote {out_path}: "
          f"{sum(a.size for a in arrays.values()) * 4 / 1e6:.1f} MB, "
          f"{len(arrays)} arrays")


if __name__ == "__main__":
    main(*sys.argv[1:])
