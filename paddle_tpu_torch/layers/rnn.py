"""RNN layers (the port's copy of ``paddle_tpu/layers/rnn.py``; reference:
python/paddle/fluid/layers/rnn.py + nn.py gru/lstm).

A recurrence is a ``Scan`` over one cell, lowered to the ``scan`` op (a
Python loop over the static length, captured whole in a step's CUDA
graph; its gradient is autograd through the loop); the gates are one
fused ``fc`` for all gates at once.
"""
from __future__ import annotations


from . import nn, tensor

__all__ = ["lstm_unit", "gru_unit", "simple_lstm", "simple_gru"]


def lstm_unit(x_t, hidden_t_prev, cell_t_prev, forget_bias=0.0, param_attr=None,
              bias_attr=None, name=None):
    """One LSTM step (reference nn.py lstm_unit). x_t [B,D], h/c [B,H]."""
    D = x_t.shape[-1]
    H = hidden_t_prev.shape[-1]
    concat_in = tensor.concat([x_t, hidden_t_prev], axis=1)
    gates = nn.fc(concat_in, 4 * H, param_attr=param_attr, bias_attr=bias_attr)
    i, f, c_hat, o = nn.split(gates, 4, dim=1)
    i = nn.sigmoid(i)
    f = nn.sigmoid(nn.scale(f, bias=forget_bias))
    c_hat = nn.tanh(c_hat)
    o = nn.sigmoid(o)
    c = nn.elementwise_add(nn.elementwise_mul(f, cell_t_prev),
                           nn.elementwise_mul(i, c_hat))
    h = nn.elementwise_mul(o, nn.tanh(c))
    return h, c


def gru_unit(x_t, hidden_prev, param_attr=None, bias_attr=None):
    """One GRU step: x_t [B,D], h [B,H]."""
    H = hidden_prev.shape[-1]
    concat_in = tensor.concat([x_t, hidden_prev], axis=1)
    zr = nn.fc(concat_in, 2 * H, param_attr=param_attr, bias_attr=bias_attr,
               act="sigmoid")
    z, r = nn.split(zr, 2, dim=1)
    cand_in = tensor.concat([x_t, nn.elementwise_mul(r, hidden_prev)], axis=1)
    cand = nn.fc(cand_in, H, param_attr=param_attr, bias_attr=bias_attr,
                 act="tanh")
    h = nn.elementwise_add(nn.elementwise_mul(z, hidden_prev),
                           nn.elementwise_mul(nn.scale(z, scale=-1.0, bias=1.0),
                                              cand))
    return h


def simple_lstm(x, hidden_size, h0=None, c0=None, param_attr=None,
                bias_attr=None, forget_bias=1.0, return_cell=False):
    """Full-sequence LSTM over padded [B, T, D] input via Scan.
    With ``return_cell`` returns (hidden_seq, cell_seq)."""
    from .control_flow import Scan
    B = x.shape[0]
    if h0 is None:
        h0 = tensor.fill_constant_batch_size_like(x, [B, hidden_size],
                                                  "float32", 0.0)
    if c0 is None:
        c0 = tensor.fill_constant_batch_size_like(x, [B, hidden_size],
                                                  "float32", 0.0)
    scan = Scan()
    with scan.step():
        x_t = scan.step_input(x)
        h_prev = scan.memory(h0)
        c_prev = scan.memory(c0)
        h, c = lstm_unit(x_t, h_prev, c_prev, forget_bias, param_attr, bias_attr)
        scan.update_memory(h_prev, h)
        scan.update_memory(c_prev, c)
        scan.step_output(h)
        if return_cell:
            scan.step_output(c)
    out = scan()
    return tuple(out) if return_cell else out


def simple_gru(x, hidden_size, h0=None, param_attr=None, bias_attr=None):
    from .control_flow import Scan
    B = x.shape[0]
    if h0 is None:
        h0 = tensor.fill_constant_batch_size_like(x, [B, hidden_size],
                                                  "float32", 0.0)
    scan = Scan()
    with scan.step():
        x_t = scan.step_input(x)
        h_prev = scan.memory(h0)
        h = gru_unit(x_t, h_prev, param_attr, bias_attr)
        scan.update_memory(h_prev, h)
        scan.step_output(h)
    return scan()
