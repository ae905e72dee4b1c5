"""Fused-cell RNNs: LSTM, GRU, ReLU, Tanh and mLSTM (counterpart of
apex_tpu/rnn; ref: apex/RNN). One input GEMM and one hidden GEMM a step
per cell, an eager loop over time, stacked layers with dropout between
them and bidirectional concatenation; see ``cells`` and ``models``."""

from apex_tpu_torch.rnn.cells import (
    GRUCell,
    LSTMCell,
    RNNReLUCell,
    RNNTanhCell,
    mLSTMCell,
)
from apex_tpu_torch.rnn.models import GRU, LSTM, RNN, ReLU, Tanh, mLSTM

__all__ = [
    "GRUCell",
    "LSTMCell",
    "RNNReLUCell",
    "RNNTanhCell",
    "mLSTMCell",
    "GRU",
    "LSTM",
    "RNN",
    "ReLU",
    "Tanh",
    "mLSTM",
]
