"""ResNet bottleneck block and its spatially parallel variant with halo
exchange (counterpart of apex_tpu/contrib/bottleneck.py; ref:
apex.contrib.bottleneck's Bottleneck and SpatialBottleneck, and the
peer-memory and NCCL halo exchangers they build on).

- Layout: the port's image convention, NCHW tensors (best in
  ``torch.channels_last`` memory) and OIHW weights; the JAX modules'
  are NHWC and HWIO (``models.convert.bottleneck_params_from_jax``).
  Each convolution casts its input and weight to ``compute_dtype``, as
  flax's ``nn.Conv(dtype=...)`` does; ``"SAME"`` padding is flax's,
  asymmetric at stride 2 (``models.resnet.same_padding``). The
  convolutions are ``F.conv2d`` (the JAX package's are XLA's, outside
  any Pallas kernel) and the BatchNorms the port's ``SyncBatchNorm``,
  whose statistics are fp32.
- ``halo_exchange_1d``: H is split over the ranks of a process group
  (the ``"cp"`` axis of ``parallel_state``, as JAX's test uses the
  context-parallel mesh axis). Each rank sends its first rows to the
  rank before and its last rows to the rank after through
  ``parallel_state.p2p`` (staged through host memory under gloo and
  counted in ``STAGED``); the edge ranks receive zero halos, which is
  the convolution's zero padding at the global border. It is an autograd
  Function: its backward sends each halo's gradient back to the rank
  that owns those rows, which JAX gets from ``ppermute``'s transpose.
- ``SpatialBottleneck`` keeps JAX's exactness trade: a strided 3x3 runs
  at stride 1 in H on the haloed rows and keeps every stride-th row from
  offset 1 (flax's SAME at stride 2 pads H by (0, 1), so the output
  centres sit on the odd global rows); BatchNorm statistics are summed
  over the spatial group and ``extra_bn_axis_names``' groups, so the
  output equals the unsharded block's up to the order of the sums.
"""

from typing import Sequence

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from apex_tpu_torch._kernels import resolve_device
from apex_tpu_torch.contrib.groupbn import axis_groups
from apex_tpu_torch.models.resnet import lecun_normal, same_padding
from apex_tpu_torch.parallel import parallel_state as ps
from apex_tpu_torch.parallel.sync_batch_norm import SyncBatchNorm

__all__ = ["Bottleneck", "SpatialBottleneck", "halo_exchange_1d"]

# p2p tags of the two directions: rows sent to the rank after, and to
# the rank before
_TAG_DOWN, _TAG_UP = 31, 32


def _swap(group, to_prev, to_next):
    """Sends ``to_prev`` to the rank before and ``to_next`` to the rank
    after; returns (what the rank before sent, what the rank after sent),
    zeros at the edges."""
    r, n = dist.get_rank(group), dist.get_world_size(group)
    sends, recvs = [], []
    if r > 0:
        sends.append((to_prev, r - 1, _TAG_UP))
        recvs.append((to_next, r - 1, _TAG_DOWN))
    if r < n - 1:
        sends.append((to_next, r + 1, _TAG_DOWN))
        recvs.append((to_prev, r + 1, _TAG_UP))
    got = ps.p2p(group, sends, recvs)
    ps.wait_sends()
    from_prev = got.pop(0) if r > 0 else torch.zeros_like(to_next)
    from_next = got.pop(0) if r < n - 1 else torch.zeros_like(to_prev)
    return from_prev, from_next


class _HaloExchange(torch.autograd.Function):
    """``cat([the rank before's last rows, x, the rank after's first
    rows], dim)``; backward returns each halo's gradient to its owner."""

    @staticmethod
    def forward(ctx, x, group, halo, dim):
        ctx.group, ctx.halo, ctx.dim = group, halo, dim
        lo = x.narrow(dim, 0, halo)
        hi = x.narrow(dim, x.shape[dim] - halo, halo)
        from_prev, from_next = _swap(group, lo, hi)
        return torch.cat([from_prev, x, from_next], dim=dim)

    @staticmethod
    def backward(ctx, g):
        halo, dim = ctx.halo, ctx.dim
        rows = g.shape[dim] - 2 * halo
        top, bottom = g.narrow(dim, 0, halo), g.narrow(dim, rows + halo,
                                                       halo)
        # the top halo's gradient belongs to the rank before's last rows,
        # the bottom one's to the rank after's first rows; what comes back
        # is the gradient of this rank's first and last rows
        grad_lo, grad_hi = _swap(ctx.group, top.contiguous(),
                                 bottom.contiguous())
        dx = g.narrow(dim, halo, rows).clone()
        dx.narrow(dim, 0, halo).add_(grad_lo)
        dx.narrow(dim, rows - halo, halo).add_(grad_hi)
        return dx, None, None, None


def halo_exchange_1d(x, axis_name: str = "cp", halo: int = 1, dim: int = 2):
    """``x`` with ``halo`` rows of each neighbour along ``dim`` (H of an
    NCHW tensor) over the ranks of ``axis_name``'s group: (N, C,
    H_local + 2 * halo, W). The edge ranks get zero halos; with no group
    (a world of one) both halos are zeros."""
    group = ps.get_group(axis_name)
    if ps.group_size(group) == 1:
        zeros = torch.zeros_like(x.narrow(dim, 0, halo))
        return torch.cat([zeros, x, zeros], dim=dim)
    return _HaloExchange.apply(x, group, halo, dim)


class _Conv(nn.Module):
    """flax ``nn.Conv`` without bias: ``weight`` (out, in, kh, kw) fp32;
    the input and the weight are cast to ``dtype`` per call. ``padding``:
    "SAME" or a pair of (low, high) pads per spatial dim."""

    def __init__(self, cin, cout, kernel, stride=(1, 1), padding="SAME",
                 dilation=1, dtype=torch.float32, device=None, gen=None):
        super().__init__()
        self.stride, self.padding = tuple(stride), padding
        self.dilation, self.dtype = dilation, dtype
        w = lecun_normal((cout, cin, kernel, kernel), cin * kernel * kernel,
                         gen).to(device)
        if w.is_cuda:
            w = w.contiguous(memory_format=torch.channels_last)
        self.weight = nn.Parameter(w)

    def forward(self, x):
        k = (self.weight.shape[-1] - 1) * self.dilation + 1
        if self.padding == "SAME":
            pads = [same_padding(n, k, s)
                    for n, s in zip(x.shape[2:], self.stride)]
        else:
            pads = self.padding
        (top, bottom), (left, right) = pads
        x = x.to(self.dtype)
        if k == 1 and all(tuple(p) == (0, 0) for p in pads):
            # a strided 1x1 reads every stride-th row and column: the same
            # products at stride 1 on those (torch's CPU backward of a
            # strided 1x1 over a channels-last input aborts)
            sh, sw = self.stride
            return F.conv2d(x[:, :, ::sh, ::sw], self.weight.to(self.dtype))
        if (top, left) != (bottom, right) or top != left:
            x = F.pad(x, (left, right, top, bottom))
            top = 0
        return F.conv2d(x, self.weight.to(self.dtype), stride=self.stride,
                        padding=top, dilation=self.dilation)


def _init(device, seed):
    return resolve_device(device), torch.Generator().manual_seed(seed)


class Bottleneck(nn.Module):
    """ResNet bottleneck 1x1 -> 3x3 -> 1x1 with BatchNorm and ReLU and a
    projection shortcut where the shape changes (ref: bottleneck.py:134;
    the stride on the 3x3). NCHW; submodules by the flax names (``conv1``
    ... ``downsample_bn``). BatchNorm statistics are summed over
    ``bn_axis_names``' groups; parameters come from ``seed``."""

    def __init__(self, in_channels: int, bottleneck_channels: int,
                 out_channels: int, stride: int = 1, dilation: int = 1,
                 compute_dtype: torch.dtype = torch.float32,
                 bn_axis_names: Sequence[str] = (), device="cuda",
                 seed: int = 0):
        super().__init__()
        dev, gen = _init(device, seed)
        groups = axis_groups(bn_axis_names)

        def conv(cin, cout, k, s, d=1):
            return _Conv(cin, cout, k, (s, s), "SAME" if k > 1 else
                         ((0, 0), (0, 0)), d, compute_dtype, dev, gen)

        def bn(c):
            return SyncBatchNorm(c, process_group=groups, device=dev)

        self.conv1 = conv(in_channels, bottleneck_channels, 1, 1)
        self.bn1 = bn(bottleneck_channels)
        self.conv2 = conv(bottleneck_channels, bottleneck_channels, 3,
                          stride, dilation)
        self.bn2 = bn(bottleneck_channels)
        self.conv3 = conv(bottleneck_channels, out_channels, 1, 1)
        self.bn3 = bn(out_channels)
        self.downsample = self.downsample_bn = None
        if stride != 1 or in_channels != out_channels:
            self.downsample = conv(in_channels, out_channels, 1, stride)
            self.downsample_bn = bn(out_channels)

    def forward(self, x, train: bool = False):
        ra = not train
        out = torch.relu(self.bn1(self.conv1(x), ra))
        out = torch.relu(self.bn2(self.conv2(out), ra))
        out = self.bn3(self.conv3(out), ra)
        shortcut = x
        if self.downsample is not None:
            shortcut = self.downsample_bn(self.downsample(x), ra)
        return torch.relu(out + shortcut)


class SpatialBottleneck(nn.Module):
    """:class:`Bottleneck` with H split over the ranks of ``axis_name``
    (ref: SpatialBottleneck, bottleneck.py:603). ``x``: this rank's rows,
    (N, C, H_local, W), H_local divisible by the stride. The 3x3 reads
    the neighbours' halo rows; BatchNorm statistics are summed over the
    spatial group and ``extra_bn_axis_names``' groups."""

    def __init__(self, in_channels: int, bottleneck_channels: int,
                 out_channels: int, stride: int = 1, axis_name: str = "cp",
                 extra_bn_axis_names: Sequence[str] = (),
                 compute_dtype: torch.dtype = torch.float32, device="cuda",
                 seed: int = 0):
        super().__init__()
        dev, gen = _init(device, seed)
        self.axis_name, self.stride = axis_name, stride
        groups = axis_groups((axis_name,) + tuple(extra_bn_axis_names))

        def conv(cin, cout, k, s, pad=((0, 0), (0, 0))):
            return _Conv(cin, cout, k, s, pad, 1, compute_dtype, dev, gen)

        def bn(c):
            return SyncBatchNorm(c, process_group=groups, device=dev)

        # W is padded as SAME pads it at the stride (k = 3, s = 2: (0, 1));
        # H takes its context from the halos, with no padding
        w_pad = (1, 1) if stride == 1 else (0, 1)
        self.conv1 = conv(in_channels, bottleneck_channels, 1, (1, 1))
        self.bn1 = bn(bottleneck_channels)
        self.conv2 = conv(bottleneck_channels, bottleneck_channels, 3,
                          (1, stride), ((0, 0), w_pad))
        self.bn2 = bn(bottleneck_channels)
        self.conv3 = conv(bottleneck_channels, out_channels, 1, (1, 1))
        self.bn3 = bn(out_channels)
        self.downsample = self.downsample_bn = None
        if stride != 1 or in_channels != out_channels:
            self.downsample = conv(in_channels, out_channels, 1,
                                   (stride, stride))
            self.downsample_bn = bn(out_channels)

    def forward(self, x, train: bool = False):
        ra = not train
        out = torch.relu(self.bn1(self.conv1(x), ra))
        haloed = halo_exchange_1d(out, self.axis_name, halo=1, dim=2)
        out = self.conv2(haloed)
        if self.stride > 1:
            out = out[:, :, 1::self.stride]
        out = torch.relu(self.bn2(out, ra))
        out = self.bn3(self.conv3(out), ra)
        shortcut = x
        if self.downsample is not None:
            shortcut = self.downsample_bn(self.downsample(x), ra)
        return torch.relu(out + shortcut)
