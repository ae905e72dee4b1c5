"""``apex.RNN`` import surface (counterpart of apex_tpu/RNN.py): the
factories of ``apex_tpu_torch.rnn``, so that ``from apex.RNN import
LSTM`` migrates as it is."""

from apex_tpu_torch.rnn import models
from apex_tpu_torch.rnn.models import GRU, LSTM, ReLU, Tanh, mLSTM

__all__ = ["models", "LSTM", "GRU", "ReLU", "Tanh", "mLSTM"]
