"""LPIPS perceptual metric (gslm_tpu/eval/lpips.py): VGG16 features with
learned linear heads, in PyTorch.

Per tapped layer (relu1_2, relu2_2, relu3_3, relu4_3, relu5_3) the
channel-normalised feature difference is squared, weighted per channel
by the layer's linear head, summed over channels and averaged over
pixels; the layers add. Images in [0, 1] are mapped to [-1, 1] and
shifted and scaled by LPIPS's constants first.

The weights load from the JAX package's ``.npz`` (one file serves both
packages; ``tools/export_lpips_weights.py`` writes it):

  conv<i>_W (kh, kw, cin, cout), conv<i>_b (cout,)   the 13 VGG16 convs
  lin<j>_W (c_j,)                                     the 5 heads

found at ``$GSLM_LPIPS_WEIGHTS`` or ``eval/lpips_vgg16.npz``; without a
file ``available()`` is False and the metrics report LPIPS as null. The
convolutions go HWIO → OIHW once at load and run as
``torch.nn.functional.conv2d`` (cuDNN on the card, not a kernel of this
port: JAX runs them as ``lax.conv_general_dilated`` outside any Pallas
kernel), with TF32 off inside the call, so a caller's TF32 setting cannot
change the metric.
"""

from __future__ import annotations

import functools
import os

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

# channel counts of the 13 VGG16 convs and the maxpool positions
VGG16_CFG = [64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
             512, 512, 512, "M", 512, 512, 512]
# indices (into the conv list) after which LPIPS taps features: relu1_2,
# relu2_2, relu3_3, relu4_3, relu5_3
TAP_AFTER_CONV = [1, 3, 6, 9, 12]

SHIFT = np.array([-0.030, -0.088, -0.188], np.float32)
SCALE = np.array([0.458, 0.448, 0.450], np.float32)

_ENV_VAR = "GSLM_LPIPS_WEIGHTS"


def default_weight_path() -> str:
    return os.environ.get(_ENV_VAR, os.path.join(
        os.path.dirname(__file__), "lpips_vgg16.npz"))


def available(path: str | None = None) -> bool:
    return os.path.exists(path or default_weight_path())


@functools.lru_cache(maxsize=2)
def _load_weights(path: str):
    """The npz's ((conv W HWIO, b) × 13, lin W × 5) as float32 numpy."""
    data = np.load(path)
    convs = []
    i = 0
    while f"conv{i}_W" in data:
        convs.append((data[f"conv{i}_W"].astype(np.float32),
                      data[f"conv{i}_b"].astype(np.float32)))
        i += 1
    lins = []
    j = 0
    while f"lin{j}_W" in data:
        lins.append(data[f"lin{j}_W"].astype(np.float32))
        j += 1
    if len(convs) != 13 or len(lins) != 5:
        raise ValueError(f"{path}: unexpected LPIPS weight file: "
                         f"{len(convs)} convs, {len(lins)} lins")
    return tuple(convs), tuple(lins)


class LPIPS(nn.Module):
    """The VGG16 trunk and the 5 linear heads of one weight file, as
    buffers (nothing to train): ``forward(img1, img2)`` → (B,)."""

    def __init__(self, path: str):
        super().__init__()
        convs, lins = _load_weights(path)
        for i, (w, b) in enumerate(convs):
            self.register_buffer(f"conv{i}_W", torch.from_numpy(
                np.ascontiguousarray(w.transpose(3, 2, 0, 1))))
            self.register_buffer(f"conv{i}_b", torch.from_numpy(b))
        for j, w in enumerate(lins):
            self.register_buffer(f"lin{j}_W", torch.from_numpy(w))
        self.register_buffer("shift", torch.from_numpy(SHIFT)[:, None, None])
        self.register_buffer("scale", torch.from_numpy(SCALE)[:, None, None])

    def features(self, x: torch.Tensor) -> list[torch.Tensor]:
        """The 5 tapped feature maps of (B, 3, H, W) normalised input."""
        feats = []
        ci = 0
        for c in VGG16_CFG:
            if c == "M":
                x = F.max_pool2d(x, 2, 2)
            else:
                x = F.relu(F.conv2d(x, getattr(self, f"conv{ci}_W"),
                                    getattr(self, f"conv{ci}_b"), padding=1))
                if ci in TAP_AFTER_CONV:
                    feats.append(x)
                ci += 1
        return feats

    def forward(self, img1: torch.Tensor, img2: torch.Tensor) -> torch.Tensor:
        def norm_input(x):
            return (2.0 * x - 1.0 - self.shift) / self.scale

        total = 0.0
        for j, (a, b) in enumerate(zip(self.features(norm_input(img1)),
                                       self.features(norm_input(img2)))):
            a = a / torch.clamp(torch.linalg.vector_norm(a, dim=1,
                                                         keepdim=True),
                                min=1e-10)
            b = b / torch.clamp(torch.linalg.vector_norm(b, dim=1,
                                                         keepdim=True),
                                min=1e-10)
            w = getattr(self, f"lin{j}_W")[None, :, None, None]
            d = torch.sum((a - b) ** 2 * w, dim=1)         # (B, H, W)
            total = total + torch.mean(d, dim=(1, 2))      # (B,)
        return total


@functools.lru_cache(maxsize=4)
def _model(path: str, device: str) -> LPIPS:
    return LPIPS(path).to(device)


def lpips(img1: torch.Tensor, img2: torch.Tensor,
          weight_path: str | None = None) -> torch.Tensor:
    """LPIPS distance per batch element of (B, 3, H, W) images in [0, 1],
    on the images' device, the convolutions in full fp32."""
    model = _model(weight_path or default_weight_path(), str(img1.device))
    cudnn = torch.backends.cudnn
    with cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                     deterministic=cudnn.deterministic, allow_tf32=False):
        return model(img1, img2)
