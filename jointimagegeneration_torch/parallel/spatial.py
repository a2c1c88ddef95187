"""Spatial sharding of activations: the mesh's 'model' axis.

The JAX package shards each UNet activation's leading spatial axis over the
mesh's 'model' axis (`P("data", "model", None, ...)`) and XLA's SPMD
partitioner inserts the exchanges between the shards.  This module holds the
port's counterparts of those exchanges, for one process that drives every
device of the axis (`parallel.mesh.Mesh`):

  * `Sharded`: a tensor split along axis 1 (D in 3D, H in 2D, or the token
    axis of a flattened sequence) into contiguous parts of equal extent,
    part i on its own device; a device may hold several parts;
  * `split` / `gather`: into parts and back to one tensor;
  * `halo`: each part with its neighbours' edge planes (zero planes at the
    volume's two ends), the input of a convolution that is VALID along the
    sharded axis;
  * `group_stats`: GroupNorm's per-sample statistics over every part, a
    global mean first and then the global mean of squared deviations from
    it, the two passes of `torch.var_mean`;
  * `gather_tokens`: every part's tokens, in part order, on each part's
    device: the keys and values of a self-attention whose queries stay
    sharded.  Row-major flattening puts each part's tokens in one
    contiguous block, so the order is the unsharded sequence's;
  * `each`: a function applied part by part.

Every exchange is a differentiable PyTorch op (slicing, `torch.cat`,
`Tensor.to(device)`), so autograd gives the backward: a gathered tensor's
gradient flows back to each part's device and sums there.  Every halo and
gather is a fresh tensor, so parts that share a device never share a buffer
that one of them writes.
"""

from __future__ import annotations

from typing import Callable, List, Sequence, Tuple

import torch

__all__ = ["Sharded", "split", "gather", "halo", "group_stats", "gather_tokens", "each"]


class Sharded:
    """A tensor split along axis 1 into parts of equal extent, in order."""

    def __init__(self, parts: Sequence[torch.Tensor]):
        self.parts = list(parts)

    @property
    def devices(self) -> List[torch.device]:
        return [p.device for p in self.parts]

    @property
    def shape(self) -> torch.Size:
        """The whole tensor's shape."""
        first = self.parts[0].shape
        return torch.Size((first[0], sum(p.shape[1] for p in self.parts), *first[2:]))

    @property
    def dtype(self) -> torch.dtype:
        return self.parts[0].dtype

    @property
    def ndim(self) -> int:
        return self.parts[0].ndim


def split(x: torch.Tensor, devices: Sequence[torch.device]) -> Sharded:
    """`x` cut along axis 1 into len(devices) equal parts, part i moved to
    devices[i]; ValueError unless the parts come out equal."""
    k = len(devices)
    if x.shape[1] % k:
        raise ValueError(f"cannot split an extent of {x.shape[1]} into {k} equal shards")
    return Sharded([p.to(d) for p, d in zip(torch.tensor_split(x, k, dim=1), devices)])


def gather(x: Sharded, device: torch.device) -> torch.Tensor:
    """The whole tensor on `device`."""
    return torch.cat([p.to(device) for p in x.parts], dim=1)


def halo(x: Sharded, left: int, right: int) -> List[torch.Tensor]:
    """Each part with the last `left` planes of the part before it and the
    first `right` planes of the part after it along axis 1; the first part
    gets `left` zero planes in front and the last `right` behind, the zero
    padding of the whole tensor."""
    out = []
    for i, p in enumerate(x.parts):
        pieces = [p]
        if left:
            prev = x.parts[i - 1][:, -left:].to(p.device) if i else p.new_zeros((p.shape[0], left, *p.shape[2:]))
            pieces.insert(0, prev)
        if right:
            last = i == len(x.parts) - 1
            nxt = p.new_zeros((p.shape[0], right, *p.shape[2:])) if last else x.parts[i + 1][:, :right].to(p.device)
            pieces.append(nxt)
        out.append(torch.cat(pieces, dim=1) if len(pieces) > 1 else p)
    return out


def group_stats(xs: Sequence[torch.Tensor]) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """Per-sample (mean, biased variance) over axes 1 and 3 of the parts of a
    grouped fp32 tensor, each part (B, n_i, G, C/G), as `torch.var_mean(x,
    dim=(1, 3), correction=0)` gives for the whole: the parts' sums are added
    on the first part's device for the mean, then their squared deviations
    from it for the variance.  Returned once per part, on its device."""
    lead = xs[0].device
    n = sum(x.shape[1] for x in xs) * xs[0].shape[3]
    mean = sum(x.sum(dim=(1, 3), keepdim=True).to(lead) for x in xs) / n
    means = [mean.to(x.device) for x in xs]
    var = sum(((x - m) ** 2).sum(dim=(1, 3), keepdim=True).to(lead) for x, m in zip(xs, means)) / n
    return means, [var.to(x.device) for x in xs]


def gather_tokens(x: Sharded) -> List[torch.Tensor]:
    """For each part, the whole tensor on that part's device (one gather per
    distinct device)."""
    whole = {}
    for d in x.devices:
        if d not in whole:
            whole[d] = gather(x, d)
    return [whole[d] for d in x.devices]


def each(fn: Callable, *args):
    """`fn(*args)` when no argument is `Sharded`; else a `Sharded` of fn
    applied part by part: a `Sharded` argument gives its part, a list its
    element for that part, a tensor is moved to the part's device, anything
    else passes as it is."""
    ref = next((a for a in args if isinstance(a, Sharded)), None)
    if ref is None:
        return fn(*args)

    def arg(a, i: int, device: torch.device):
        if isinstance(a, Sharded):
            return a.parts[i]
        if isinstance(a, list):
            return a[i]
        return a.to(device) if isinstance(a, torch.Tensor) else a

    return Sharded([fn(*(arg(a, i, d) for a in args)) for i, d in enumerate(ref.devices)])
