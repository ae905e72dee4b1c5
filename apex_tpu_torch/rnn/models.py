"""Stacked and bidirectional RNNs (counterpart of apex_tpu/rnn/models.py;
ref: apex/RNN/models.py and RNNBackend).

``RNN`` runs a cell over time in an eager loop (the JAX module's
``nn.scan``), one step after another, stacks layers with dropout between
them (drawn from a ``torch.Generator`` the caller hands in) and
concatenates the two directions of a bidirectional layer. Inputs are
(seq, batch, features). Submodules carry the flax scope names
(``layer<l>``, ``layer<l>_reverse``, each with its ``cell``), so
``models.convert.rnn_params_from_jax`` is a path join.
"""

import torch
from torch import nn

from apex_tpu_torch._kernels import resolve_device
from apex_tpu_torch.rnn.cells import (
    GRUCell,
    LSTMCell,
    RNNReLUCell,
    RNNTanhCell,
    mLSTMCell,
)
from apex_tpu_torch.transformer.layer import keep_mask

__all__ = ["GRU", "LSTM", "RNN", "ReLU", "Tanh", "mLSTM"]


class _ScannedCell(nn.Module):
    """One direction of one layer: ``cell`` over the time steps, from
    the last one when ``reverse``; outputs stay in time order."""

    def __init__(self, cell: nn.Module, reverse: bool = False):
        super().__init__()
        self.cell, self.reverse = cell, reverse

    def forward(self, xs, carry=None):
        if carry is None:
            carry = self.cell.init_carry(xs.shape[1], self.cell.hidden_size,
                                         xs.dtype, xs.device)
        steps = range(xs.shape[0])
        ys = [None] * xs.shape[0]
        for t in (reversed(steps) if self.reverse else steps):
            carry, ys[t] = self.cell(carry, xs[t])
        return torch.stack(ys), carry


class RNN(nn.Module):
    """(ref: RNNBackend.RNNBase) ``cell_cls`` over ``num_layers`` layers;
    parameters in ``params_dtype`` from ``seed`` on ``device``."""

    def __init__(self, cell_cls, input_size: int, hidden_size: int,
                 num_layers: int = 1, bidirectional: bool = False,
                 dropout: float = 0.0, use_bias: bool = True,
                 params_dtype: torch.dtype = torch.float32, device="cuda",
                 seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        gen = torch.Generator().manual_seed(seed)
        self.num_layers, self.bidirectional = num_layers, bidirectional
        self.dropout = dropout
        width = input_size
        for layer in range(num_layers):
            for suffix, rev in (("", False), ("_reverse", True)):
                if rev and not bidirectional:
                    continue
                cell = cell_cls(width, hidden_size, use_bias, params_dtype,
                                dev, gen)
                self.add_module(f"layer{layer}{suffix}",
                                _ScannedCell(cell, rev))
            width = hidden_size * (2 if bidirectional else 1)

    def forward(self, xs, deterministic: bool = True, generator=None):
        """``xs``: (seq, batch, features); returns (the last layer's
        outputs, each layer's final carry, a (forward, backward) pair when
        bidirectional)."""
        h, finals = xs, []
        for layer in range(self.num_layers):
            fwd, carry_f = getattr(self, f"layer{layer}")(h)
            if self.bidirectional:
                bwd, carry_b = getattr(self, f"layer{layer}_reverse")(h)
                h = torch.cat([fwd, bwd], dim=-1)
                finals.append((carry_f, carry_b))
            else:
                h = fwd
                finals.append(carry_f)
            if (self.dropout > 0.0 and layer < self.num_layers - 1
                    and not deterministic):
                if generator is None:
                    raise ValueError("dropout in training mode needs a "
                                     "generator")
                keep = keep_mask(generator, 1.0 - self.dropout, h.shape,
                                 h.device)
                h = torch.where(keep, h / (1.0 - self.dropout), 0.0).to(
                    h.dtype)
        return h, finals


def _factory(cell_cls):
    def make(input_size, hidden_size, num_layers=1, bias=True, dropout=0.0,
             bidirectional=False, **kw):
        return RNN(cell_cls, input_size, hidden_size, num_layers=num_layers,
                   use_bias=bias, dropout=dropout,
                   bidirectional=bidirectional, **kw)
    return make


LSTM = _factory(LSTMCell)
GRU = _factory(GRUCell)
ReLU = _factory(RNNReLUCell)
Tanh = _factory(RNNTanhCell)


def mLSTM(input_size, hidden_size, num_layers=1, bias=True, dropout=0.0,
          **kw):
    """(ref: RNN/models.py mLSTM; unidirectional, as there)"""
    return RNN(mLSTMCell, input_size, hidden_size, num_layers=num_layers,
               use_bias=bias, dropout=dropout, **kw)
