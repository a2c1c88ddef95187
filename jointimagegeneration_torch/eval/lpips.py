"""LPIPS perceptual distance (VGG16 features) and its three-view volume mean.

Counterpart of `jointimagegeneration_tpu/eval/lpips.py`.  Inputs are in
[0, 1], channels-last (B, H, W, 1 | 3); grey inputs are tiled to 3 channels,
inputs below 64 px are resized up (bilinear with half-pixel centres, what
`jax.image.resize(..., "linear")` computes when it upsamples), mapped to
[-1, 1] and through LPIPS' shift and scale.  The distance sums, over the
taps relu1_2 ... relu5_3, the spatial mean of the squared difference of the
unit-normalised features, each channel weighted by the learned `lin` heads
when they are loaded.

Weights come from the `.npz` of `scripts/convert_lpips_weights.py`
(`conv_<i>_kernel` HWIO, `conv_<i>_bias`, `lin_<k>`) or from a torch
checkpoint (torchvision `features.<i>.*`, convs taken in sorted order, and /
or the LPIPS heads `lin<k>.model.1.weight`).  Without weights the tower is
the port's own seeded lecun-normal init: a valid but uncalibrated metric
(zero for equal inputs, symmetric), for relative comparisons only.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..core.runtime import resolve_device
from ..nn.unet import init_weights

__all__ = ["VGG16Features", "LPIPS", "lpips_three_view", "parse_torch_lpips_sd"]

_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)
_VGG_CFG = [64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512, "M", 512, 512, 512]
_TAPS = (1, 3, 6, 9, 12)  # conv indices whose ReLU output is a tap
_N_CONVS = sum(v != "M" for v in _VGG_CFG)


class VGG16Features(nn.Module):
    """VGG16's 13 3x3 convs (`conv0` ... `conv12`) with ReLU and 2x2 max pools;
    NCHW in, the five tap activations out."""

    def __init__(self, device=None):
        super().__init__()
        cin, i = 3, 0
        for v in _VGG_CFG:
            if v != "M":
                self.add_module(f"conv{i}", nn.Conv2d(cin, v, 3, padding=1, device=device))
                cin, i = v, i + 1

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        feats, i = [], 0
        for v in _VGG_CFG:
            if v == "M":
                x = F.max_pool2d(x, 2, 2)
                continue
            x = F.relu(getattr(self, f"conv{i}")(x))
            if i in _TAPS:
                feats.append(x)
            i += 1
        return feats


def parse_torch_lpips_sd(sd) -> tuple:
    """A torch state dict -> (conv weights OIHW by conv position, conv biases,
    lin heads by index).  torchvision's `features.<slot>` slots include the
    ReLU and pool positions, so convs are taken in sorted slot order."""
    conv_w, conv_b, lins = {}, {}, {}
    conv_keys = sorted((k for k, v in sd.items() if k.endswith(".weight") and v.ndim == 4 and "lin" not in k),
                       key=lambda k: [int(p) if p.isdigit() else p for p in k.split(".")])
    for pos, k in enumerate(conv_keys):
        conv_w[pos] = np.asarray(sd[k])
        bk = k[: -len("weight")] + "bias"
        if bk in sd:
            conv_b[pos] = np.asarray(sd[bk])
    for k, v in sd.items():
        if "lin" in k and v.ndim == 4 and v.shape[0] == 1:
            idx = int("".join(ch for ch in k.split(".")[0] if ch.isdigit()) or len(lins))
            lins[idx] = np.asarray(v).reshape(-1)
    return conv_w, conv_b, lins


class LPIPS:
    """`LPIPS(weights_path)(a, b)` -> (B,) distances."""

    def __init__(self, weights_path: Optional[str] = None, device=None, seed: int = 0):
        self.device = resolve_device(device)
        self.net = VGG16Features(self.device).eval()
        generator = torch.Generator(device=self.device)
        generator.manual_seed(seed)
        init_weights(self.net, generator)
        self.lin_weights: Optional[List[torch.Tensor]] = None
        if weights_path:
            self.load(weights_path)

    def load(self, path: str) -> None:
        if str(path).endswith(".npz"):
            with np.load(path) as z:
                part = lambda prefix, suffix: {int(k.split("_")[1]): z[k] for k in z.files  # noqa: E731
                                               if k.startswith(prefix) and k.endswith(suffix)}
                conv_w = {i: np.transpose(w, (3, 2, 0, 1)) for i, w in part("conv_", "_kernel").items()}
                self.install(conv_w, part("conv_", "_bias"), part("lin_", ""))
            return
        sd = torch.load(path, map_location="cpu")
        if hasattr(sd, "state_dict"):
            sd = sd.state_dict()
        self.install(*parse_torch_lpips_sd({k: v.numpy() if torch.is_tensor(v) else v for k, v in sd.items()}))

    def install(self, conv_w: Dict[int, np.ndarray], conv_b: Dict[int, np.ndarray],
                lins: Dict[int, np.ndarray]) -> None:
        """Conv weights (OIHW) and biases by conv position, where the shapes
        fit; the lin heads when any are given."""
        with torch.no_grad():
            for i in range(_N_CONVS):
                conv = getattr(self.net, f"conv{i}")
                if i in conv_w and tuple(np.shape(conv_w[i])) == tuple(conv.weight.shape):
                    conv.weight.copy_(torch.as_tensor(np.asarray(conv_w[i], np.float32)))
                    if i in conv_b:
                        conv.bias.copy_(torch.as_tensor(np.asarray(conv_b[i], np.float32)))
        if lins:
            self.lin_weights = [torch.as_tensor(np.asarray(lins[k], np.float32), device=self.device)
                                for k in sorted(lins)]

    def _features(self, x: torch.Tensor) -> List[torch.Tensor]:
        x = x.float().to(self.device)
        if x.shape[-1] == 1:
            x = x.repeat(1, 1, 1, 3)
        x = x.permute(0, 3, 1, 2)
        h, w = x.shape[2:]
        if h < 64 or w < 64:  # VGG pools four times
            x = F.interpolate(x, size=(max(h, 64), max(w, 64)), mode="bilinear", align_corners=False)
        shift = torch.tensor(_SHIFT, device=x.device).view(1, 3, 1, 1)
        scale = torch.tensor(_SCALE, device=x.device).view(1, 3, 1, 1)
        return self.net(((2.0 * x - 1.0) - shift) / scale)

    @torch.no_grad()
    def __call__(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        total = 0.0
        for i, (fa, fb) in enumerate(zip(self._features(a), self._features(b))):
            d = (_unit(fa) - _unit(fb)) ** 2
            if self.lin_weights is not None and i < len(self.lin_weights):
                d = d * self.lin_weights[i].view(1, -1, 1, 1)
            total = total + d.sum(dim=1).mean(dim=(1, 2))
        return total


def _unit(x: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
    return x / torch.sqrt((x ** 2).sum(dim=1, keepdim=True) + eps)


def lpips_three_view(metric: LPIPS, vol_a: torch.Tensor, vol_b: torch.Tensor) -> torch.Tensor:
    """Mean LPIPS over the axial, coronal and sagittal mid-slices of two
    (D, H, W) volumes."""
    d, h, w = vol_a.shape
    pairs = [(vol_a[d // 2], vol_b[d // 2]), (vol_a[:, h // 2], vol_b[:, h // 2]),
             (vol_a[:, :, w // 2], vol_b[:, :, w // 2])]
    return torch.stack([metric(a[None, ..., None], b[None, ..., None])[0] for a, b in pairs]).mean()
