"""RNN cells with fused gate GEMMs (counterpart of apex_tpu/rnn/cells.py;
ref: apex/RNN/cells.py, RNNBackend.py).

Every cell maps ``(carry, x) -> (carry, y)``. Its gates come from ONE
input GEMM and ONE hidden GEMM a step (the reference's "fused"
formulation), in fp32 (products of the input's dtype summed in fp32, as
JAX's ``preferred_element_type``), and the nonlinearities run in fp32.
Parameters keep the flax names and layouts, ``wi`` (in, gates * hidden)
and ``wh`` (hidden, gates * hidden), so a JAX tree loads by a path join;
gate order LSTM i, f, g, o and GRU r, z, n. Plain torch: cuDNN's RNNs
have no mLSTM and another parameter layout.
"""

import torch
from torch import nn

from apex_tpu_torch.models.resnet import lecun_normal

__all__ = ["GRUCell", "LSTMCell", "RNNReLUCell", "RNNTanhCell", "mLSTMCell"]


def _dense(x, kernel, bias=None):
    """fp32 ``x @ kernel`` with the kernel cast to x's dtype (+ bias)."""
    y = torch.matmul(x.float(), kernel.to(x.dtype).float())
    if bias is not None:
        y = y + bias.float()
    return y


class _Cell(nn.Module):
    """Parameters by name: (rows, columns) and an initializer each."""

    def __init__(self, input_size: int, hidden_size: int,
                 use_bias: bool = True,
                 params_dtype: torch.dtype = torch.float32, device=None,
                 gen: torch.Generator = None):
        super().__init__()
        self.input_size, self.hidden_size = input_size, hidden_size
        self.use_bias = use_bias
        self._args = (params_dtype, device, gen)

    def _weight(self, name, rows, cols, orthogonal=False):
        dtype, device, gen = self._args
        if orthogonal:
            t = torch.empty(rows, cols)
            nn.init.orthogonal_(t, generator=gen)
        else:
            t = lecun_normal((rows, cols), rows, gen)
        self.register_parameter(name, nn.Parameter(
            t.to(device=device, dtype=dtype)))

    def _bias(self, name, n):
        dtype, device, _ = self._args
        self.register_parameter(name, nn.Parameter(torch.zeros(
            n, dtype=dtype, device=device)) if self.use_bias else None)

    @staticmethod
    def init_carry(batch, hidden, dtype=torch.float32, device=None):
        return (torch.zeros(batch, hidden, dtype=dtype, device=device),)


class LSTMCell(_Cell):
    """(ref: RNNBackend's LSTM cell; gate order i, f, g, o)"""

    def __init__(self, input_size, hidden_size, use_bias=True,
                 params_dtype=torch.float32, device=None, gen=None):
        super().__init__(input_size, hidden_size, use_bias, params_dtype,
                         device, gen)
        self._weight("wi", input_size, 4 * hidden_size)
        self._weight("wh", hidden_size, 4 * hidden_size, orthogonal=True)
        self._bias("bias", 4 * hidden_size)

    def _gates(self, h, x):
        return _dense(x, self.wi, self.bias) + _dense(h, self.wh)

    def forward(self, carry, x):
        h, c = carry
        i, f, g, o = self._gates(h, x).chunk(4, dim=-1)
        new_c = torch.sigmoid(f) * c.float() + torch.sigmoid(i) * torch.tanh(g)
        new_h = (torch.sigmoid(o) * torch.tanh(new_c)).to(x.dtype)
        return (new_h, new_c.to(c.dtype)), new_h

    @staticmethod
    def init_carry(batch, hidden, dtype=torch.float32, device=None):
        return tuple(torch.zeros(batch, hidden, dtype=dtype, device=device)
                     for _ in range(2))


class mLSTMCell(LSTMCell):
    """Multiplicative LSTM (ref: apex/RNN mLSTM): ``m = (x Wmx) * (h
    Wmh)`` takes h's place in the hidden GEMM."""

    def __init__(self, input_size, hidden_size, use_bias=True,
                 params_dtype=torch.float32, device=None, gen=None):
        _Cell.__init__(self, input_size, hidden_size, use_bias,
                       params_dtype, device, gen)
        self._weight("wmx", input_size, hidden_size)
        self._weight("wmh", hidden_size, hidden_size, orthogonal=True)
        self._weight("wi", input_size, 4 * hidden_size)
        self._weight("wh", hidden_size, 4 * hidden_size, orthogonal=True)
        self._bias("bias", 4 * hidden_size)

    def _gates(self, h, x):
        m = (_dense(x, self.wmx) * _dense(h, self.wmh)).to(x.dtype)
        return _dense(x, self.wi, self.bias) + _dense(m, self.wh)


class GRUCell(_Cell):
    """(gate order r, z, n, torch's)"""

    def __init__(self, input_size, hidden_size, use_bias=True,
                 params_dtype=torch.float32, device=None, gen=None):
        super().__init__(input_size, hidden_size, use_bias, params_dtype,
                         device, gen)
        self._weight("wi", input_size, 3 * hidden_size)
        self._weight("wh", hidden_size, 3 * hidden_size, orthogonal=True)
        self._bias("bi", 3 * hidden_size)
        self._bias("bh", 3 * hidden_size)

    def forward(self, carry, x):
        (h,) = carry
        ir, iz, inn = _dense(x, self.wi, self.bi).chunk(3, dim=-1)
        hr, hz, hn = _dense(h, self.wh, self.bh).chunk(3, dim=-1)
        r = torch.sigmoid(ir + hr)
        z = torch.sigmoid(iz + hz)
        n = torch.tanh(inn + r * hn)
        new_h = ((1.0 - z) * n + z * h.float()).to(x.dtype)
        return (new_h,), new_h


class _ElementwiseCell(_Cell):
    def __init__(self, input_size, hidden_size, use_bias=True,
                 params_dtype=torch.float32, device=None, gen=None):
        super().__init__(input_size, hidden_size, use_bias, params_dtype,
                         device, gen)
        self._weight("wi", input_size, hidden_size)
        self._weight("wh", hidden_size, hidden_size, orthogonal=True)
        self._bias("bias", hidden_size)

    def forward(self, carry, x):
        (h,) = carry
        y = self._act(_dense(x, self.wi, self.bias)
                      + _dense(h, self.wh)).to(x.dtype)
        return (y,), y


class RNNReLUCell(_ElementwiseCell):
    _act = staticmethod(torch.relu)


class RNNTanhCell(_ElementwiseCell):
    _act = staticmethod(torch.tanh)
