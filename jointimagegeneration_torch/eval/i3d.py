"""I3D (Inflated Inception-V1), the FVD backbone.

Counterpart of `jointimagegeneration_tpu/eval/i3d.py`: the Kinetics-400 I3D as
a function of a params dict {unit: {"kernel" (DHWIO), "scale", "bias"}}, the
BatchNorm folded into a per-channel affine at conversion (inference only).
Weights come from a torch checkpoint in the standard `<Unit>.conv3d.weight` /
`<Unit>.bn.*` naming (`parse_torch_i3d_sd`, `cli/convert_i3d.py`) through the
`.npz` that both packages read (`load_i3d_npz`).  The output is the
time-averaged 400-way logits, the TF-hub FVD convention.

The convs are stock `F.conv3d` in fp32 (XLA computes them in the JAX
package, no Pallas kernel); run them with TF32 off
(`core.runtime.configure_precision`).  TensorFlow's 'SAME' padding is
asymmetric: for size n, kernel k and stride s the output is ceil(n / s) and
the total pad max((out - 1) s + k - n, 0), its floor half before and the rest
after.  So every conv and max pool pads explicitly (the pools with -inf, as
flax's `max_pool`) and then runs VALID; `F.max_pool3d(padding=...)` pads
symmetrically and would differ at odd sizes.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Mapping, Sequence, Union

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["I3D_MIXED_SPEC", "i3d_features", "parse_torch_i3d_sd", "load_i3d_npz"]

# Inception-V1 mixed blocks: name -> (b0, b1a, b1b, b2a, b2b, b3b) widths.
# Branches: b0 1x1 | b1a 1x1 -> b1b 3x3 | b2a 1x1 -> b2b 3x3 |
#           maxpool 3x3x3 (stride 1) -> b3b 1x1; outputs concatenated.
I3D_MIXED_SPEC = [
    ("Mixed_3b", (64, 96, 128, 16, 32, 32)),
    ("Mixed_3c", (128, 128, 192, 32, 96, 64)),
    ("MaxPool3d_4a_3x3", None),
    ("Mixed_4b", (192, 96, 208, 16, 48, 64)),
    ("Mixed_4c", (160, 112, 224, 24, 64, 64)),
    ("Mixed_4d", (128, 128, 256, 24, 64, 64)),
    ("Mixed_4e", (112, 144, 288, 32, 64, 64)),
    ("Mixed_4f", (256, 160, 320, 32, 128, 128)),
    ("MaxPool3d_5a_2x2", None),
    ("Mixed_5b", (256, 160, 320, 32, 128, 128)),
    ("Mixed_5c", (384, 192, 384, 48, 128, 128)),
]

Params = Mapping[str, Mapping[str, torch.Tensor]]


def _same_pad(x: torch.Tensor, window: Sequence[int], stride: Sequence[int], value: float) -> torch.Tensor:
    """TF 'SAME' padding of the three spatial axes of an NCDHW tensor."""
    pads = []
    for n, k, s in zip(reversed(x.shape[2:]), reversed(window), reversed(stride)):
        total = max((-(-n // s) - 1) * s + k - n, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads, value=value) if any(pads) else x


def _unit(x: torch.Tensor, p: Mapping[str, torch.Tensor], stride=(1, 1, 1), relu: bool = True) -> torch.Tensor:
    """'SAME' conv + the folded BN affine (+ ReLU)."""
    w = p["kernel"].permute(4, 3, 0, 1, 2)  # DHWIO -> OIDHW
    y = F.conv3d(_same_pad(x, w.shape[2:], stride, 0.0), w, stride=stride)
    y = y * p["scale"].view(1, -1, 1, 1, 1) + p["bias"].view(1, -1, 1, 1, 1)
    return F.relu(y) if relu else y


def _maxpool(x: torch.Tensor, window, stride) -> torch.Tensor:
    return F.max_pool3d(_same_pad(x, window, stride, float("-inf")), window, stride)


def _mixed(x: torch.Tensor, params: Params, name: str) -> torch.Tensor:
    b0 = _unit(x, params[f"{name}.b0"])
    b1 = _unit(_unit(x, params[f"{name}.b1a"]), params[f"{name}.b1b"])
    b2 = _unit(_unit(x, params[f"{name}.b2a"]), params[f"{name}.b2b"])
    b3 = _unit(_maxpool(x, (3, 3, 3), (1, 1, 1)), params[f"{name}.b3b"])
    return torch.cat([b0, b1, b2, b3], dim=1)


def i3d_features(params: Params, video: torch.Tensor) -> torch.Tensor:
    """(B, T, H, W, 3) video in [-1, 1] -> (B, 400) time-averaged logits, fp32."""
    x = video.float().permute(0, 4, 1, 2, 3)  # NCDHW, the layout F.conv3d takes
    x = _unit(x, params["Conv3d_1a_7x7"], stride=(2, 2, 2))
    x = _maxpool(x, (1, 3, 3), (1, 2, 2))
    x = _unit(x, params["Conv3d_2b_1x1"])
    x = _unit(x, params["Conv3d_2c_3x3"])
    x = _maxpool(x, (1, 3, 3), (1, 2, 2))
    for name, spec in I3D_MIXED_SPEC:
        if spec is None:
            x = _maxpool(x, (3, 3, 3) if name.endswith("3x3") else (2, 2, 2), (2, 2, 2))
        else:
            x = _mixed(x, params, name)
    # spatial mean per time step, the 1x1x1 logits unit, then the mean over time
    x = _unit(x.mean(dim=(3, 4), keepdim=True), params["logits"], relu=False)
    return x.mean(dim=(2, 3, 4))


def parse_torch_i3d_sd(sd: Mapping, eps: float = 1e-3) -> Dict[str, Dict[str, np.ndarray]]:
    """A torch I3D state dict -> {unit: {kernel (DHWIO), scale, bias}} (numpy
    fp32), the BN folded: gamma (x - mean) / sqrt(var + eps) + beta = scale *
    conv + bias.  Takes `<Unit>.conv3d.weight` (+ an optional `.conv3d.bias`)
    and `<Unit>.bn.{weight,bias,running_mean,running_var}`; a unit without a
    BN (the logits head) keeps its conv bias."""
    def arr(v) -> np.ndarray:
        return (v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)).astype(np.float32)

    units: Dict[str, Dict[str, np.ndarray]] = {}
    for k, v in sd.items():
        if not k.endswith("conv3d.weight"):
            continue
        unit = k[: -len(".conv3d.weight")]
        kern = np.transpose(arr(v), (2, 3, 4, 1, 0))  # OIDHW -> DHWIO
        cout = kern.shape[-1]
        scale = np.ones((cout,), np.float32)
        bias = arr(sd[f"{unit}.conv3d.bias"]) if f"{unit}.conv3d.bias" in sd else np.zeros((cout,), np.float32)
        if f"{unit}.bn.running_var" in sd:
            gamma = arr(sd[f"{unit}.bn.weight"]) if f"{unit}.bn.weight" in sd else scale
            beta = arr(sd[f"{unit}.bn.bias"]) if f"{unit}.bn.bias" in sd else bias * 0
            mean, var = arr(sd[f"{unit}.bn.running_mean"]), arr(sd[f"{unit}.bn.running_var"])
            scale = gamma / np.sqrt(var + eps)
            bias = beta - mean * scale + bias * scale
        units[unit] = {"kernel": kern, "scale": scale, "bias": bias}
    return units


def load_i3d_npz(path: Union[str, Path], device="cpu") -> Dict[str, Dict[str, torch.Tensor]]:
    """The `.npz` of `cli/convert_i3d.py` (or the JAX package's
    `scripts/convert_i3d_weights.py`; keys `<unit>/<leaf>`) as `i3d_features`
    params, fp32 tensors on `device`."""
    params: Dict[str, Dict[str, torch.Tensor]] = {}
    with np.load(path) as raw:
        for key in raw.files:
            unit, leaf = key.rsplit("/", 1)
            params.setdefault(unit, {})[leaf] = torch.from_numpy(np.asarray(raw[key], np.float32)).to(device)
    return params
