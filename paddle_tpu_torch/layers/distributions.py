"""Probability distributions DSL (the port's copy of
``paddle_tpu/layers/distributions.py``; reference
python/paddle/fluid/layers/distributions.py:28,113,247,400,493 --
Distribution / Uniform / Normal / Categorical / MultivariateNormalDiag).

sample / entropy / log_prob / kl_divergence build ops into the default
program, the same ops as the JAX package's. Parameters go through one
``_normalize_params`` helper, and sampling through one ``_draw`` path: the
``*_batch_size_like`` ops for parameters with a runtime batch (the port's
counter-derived generator, drawn anew at each run and each replay of a
captured step), ``uniform_random`` / ``gaussian_random`` otherwise. The
closed forms (normal KL, categorical entropy, the diagonal-MVN algebra) are
held against the oracles of tests/test_distributions.py by
tests/test_torch_extra_layers.py."""
from __future__ import annotations

import math

import numpy as np

from ..framework import Variable
from . import nn
from . import tensor
from . import extras
from . import control_flow


__all__ = ["Distribution", "Uniform", "Normal", "Categorical",
           "MultivariateNormalDiag"]

_HALF_LOG_2PI = 0.5 * math.log(2.0 * math.pi)


def _normalize_params(*args):
    """(params, dynamic_batch, squeeze_scalar) for a distribution's
    parameter tuple.

    Variables pass through with dynamic_batch=True (their leading dim is
    the runtime batch, so sampling must route through the
    *_batch_size_like ops). Python scalars / lists / ndarrays are
    materialized as f32 constants; when EVERY argument was a bare float the
    result is flagged squeeze_scalar so sample() can drop the synthetic
    [1] parameter dim, matching the reference's scalar-argument shape
    contract. Mixing Variables with host values is rejected (as the
    reference does)."""
    kinds = {isinstance(a, Variable) for a in args}
    if kinds == {True}:
        return args, True, False
    if True in kinds:
        raise ValueError("distribution parameters must be all Variables or "
                         "all host values (no mixing, as in the reference)")
    squeeze = all(isinstance(a, float) for a in args)
    consts = []
    for a in args:
        host = np.asarray(a, dtype="float32")
        consts.append(tensor.assign(host.reshape(1) if host.ndim == 0
                                    else host))
    return tuple(consts), False, squeeze


def _draw(anchor, param_shape, sample_shape, batch_sampler, static_sampler,
          dynamic_batch):
    """Standard-distribution draw of shape [sample_shape..., param_shape...].

    dynamic_batch: param_shape[0] is -1 (the runtime batch of ``anchor``).
    The *_batch_size_like ops pin the runtime batch to a fixed dim, so the
    draw happens as [batch..., prod(sample_shape)] and the sample axis is
    rotated to the front -- same output contract, no dependence on the
    reference's broadcast temporary."""
    if not dynamic_batch:
        return static_sampler(list(sample_shape) + list(param_shape))
    width = int(np.prod(sample_shape)) if len(sample_shape) else 1
    proto = tensor.fill_constant_batch_size_like(
        anchor, list(param_shape) + [width], "float32", 0.0)
    flat = batch_sampler(proto)                    # [batch..., width]
    rank = len(param_shape)
    rotated = nn.transpose(flat, [rank] + list(range(rank)))
    return nn.reshape(rotated, list(sample_shape) + list(param_shape))


class Distribution(object):
    """Abstract base (reference distributions.py:28)."""

    def sample(self, shape, seed=0):
        raise NotImplementedError("subclasses provide sample()")

    def entropy(self):
        raise NotImplementedError("subclasses provide entropy()")

    def kl_divergence(self, other):
        raise NotImplementedError("subclasses provide kl_divergence()")

    def log_prob(self, value):
        raise NotImplementedError("subclasses provide log_prob()")


class Uniform(Distribution):
    """U(low, high) (reference distributions.py:113)."""

    def __init__(self, low, high):
        (self.low, self.high), self._dynamic_batch, self._squeeze = \
            _normalize_params(low, high)

    def sample(self, shape, seed=0):
        span = self.low + self.high        # broadcast -> parameter shape
        pshape = list(span.shape)
        unit = _draw(
            span, pshape, shape,
            lambda p: extras.uniform_random_batch_size_like(
                p, p.shape, min=0.0, max=1.0, seed=seed),
            lambda s: nn.uniform_random(s, min=0.0, max=1.0, seed=seed),
            self._dynamic_batch)
        drawn = unit * (self.high - self.low) + self.low
        return nn.reshape(drawn, shape) if self._squeeze else drawn

    def log_prob(self, value):
        # log(1/(high-low)) inside the support; -inf outside via log(0)
        inside = (tensor.cast(control_flow.less_than(self.low, value),
                              dtype=value.dtype) *
                  tensor.cast(control_flow.less_than(value, self.high),
                              dtype=value.dtype))
        return nn.log(inside) - nn.log(self.high - self.low)

    def entropy(self):
        span = self.high - self.low
        return nn.log(span)


class Normal(Distribution):
    """N(loc, scale) (reference distributions.py:247)."""

    def __init__(self, loc, scale):
        (self.loc, self.scale), self._dynamic_batch, self._squeeze = \
            _normalize_params(loc, scale)

    def sample(self, shape, seed=0):
        anchor = self.loc + self.scale
        pshape = list(anchor.shape)
        eps = _draw(
            anchor, pshape, shape,
            lambda p: extras.gaussian_random_batch_size_like(
                p, p.shape, mean=0.0, std=1.0, seed=seed),
            lambda s: nn.gaussian_random(s, mean=0.0, std=1.0, seed=seed),
            self._dynamic_batch)
        drawn = eps * self.scale + self.loc
        return nn.reshape(drawn, shape) if self._squeeze else drawn

    def entropy(self):
        # H = 1/2 + 1/2 log(2 pi) + log sigma, broadcast to parameter shape
        # (the zeros_like ride keeps the runtime-batch dim when dynamic)
        anchor = self.loc + self.scale
        widen = tensor.fill_constant_batch_size_like(
            anchor, list(anchor.shape), "float32", 0.0)
        return (0.5 + _HALF_LOG_2PI) + nn.log(self.scale + widen)

    def log_prob(self, value):
        # -(x-mu)^2 / (2 sigma^2) - log sigma - log sqrt(2 pi)
        dev = value - self.loc
        return (-(dev * dev) / (2.0 * (self.scale * self.scale))
                - nn.log(self.scale) - _HALF_LOG_2PI)

    def kl_divergence(self, other):
        """KL(p||q) = log(sq/sp) + (sp^2 + (mp-mq)^2) / (2 sq^2) - 1/2."""
        assert isinstance(other, Normal), "kl_divergence needs a Normal"
        ssq_p = self.scale * self.scale
        ssq_q = other.scale * other.scale
        mean_gap = self.loc - other.loc
        return (nn.log(other.scale) - nn.log(self.scale)
                + (ssq_p + mean_gap * mean_gap) / (2.0 * ssq_q) - 0.5)


class Categorical(Distribution):
    """Categorical over unnormalized log-probabilities (reference
    distributions.py:400; the reference surface is entropy + kl_divergence)."""

    def __init__(self, logits):
        self.logits = (logits if isinstance(logits, Variable) else
                       _normalize_params(np.asarray(logits))[0][0])

    def _log_softmax(self):
        """(log-probabilities, probabilities) with a max-shift for
        stability; both on the last axis."""
        centered = self.logits - nn.reduce_max(
            self.logits, dim=-1, keep_dim=True)
        log_norm = nn.log(nn.reduce_sum(
            nn.exp(centered), dim=-1, keep_dim=True))
        logp = centered - log_norm
        return logp, nn.exp(logp)

    def kl_divergence(self, other):
        """sum_i p_i (log p_i - log q_i), on the shared last axis."""
        assert isinstance(other, Categorical), "needs a Categorical"
        logp, p = self._log_softmax()
        logq, _ = other._log_softmax()
        return nn.reduce_sum(p * (logp - logq), dim=-1, keep_dim=True)

    def entropy(self):
        logp, p = self._log_softmax()
        return -1.0 * nn.reduce_sum(p * logp, dim=-1, keep_dim=True)


class MultivariateNormalDiag(Distribution):
    """Multivariate normal with diagonal covariance passed as a [k, k]
    diagonal matrix (reference distributions.py:493; surface is entropy +
    kl_divergence)."""

    def __init__(self, loc, scale):
        (self.loc, self.scale), _, _ = _normalize_params(loc, scale)

    def _offdiag_mask(self, like):
        """[k, k] with 0 on the diagonal, 1 elsewhere."""
        k = list(like.shape)[0]
        eye = tensor.diag(tensor.ones(shape=[k], dtype="float32"))
        return tensor.ones(shape=list(like.shape), dtype="float32") - eye

    def _diag_prod(self, mat):
        """prod of diagonal entries: off-diagonal cells are lifted to 1
        before the global reduce_prod."""
        return nn.reduce_prod(mat + self._offdiag_mask(mat))

    def _diag_recip(self, mat):
        """elementwise mat^(+-1): exponent +1 off-diagonal (keeps the
        zeros of a diagonal matrix), -1 on the diagonal (1/v)."""
        exponent = 2.0 * self._offdiag_mask(mat) - 1.0
        return nn.elementwise_pow(mat, exponent)

    def entropy(self):
        """k/2 (1 + log 2 pi) + 1/2 log det(Sigma)."""
        k = int(self.scale.shape[0])
        return 0.5 * (k * (1.0 + 2.0 * _HALF_LOG_2PI)
                      + nn.log(self._diag_prod(self.scale)))

    def kl_divergence(self, other):
        """1/2 [tr(Sq^-1 Sp) + (mq-mp)^T Sq^-1 (mq-mp) - k
        + log(det Sq / det Sp)]."""
        assert isinstance(other, MultivariateNormalDiag), \
            "kl_divergence needs a MultivariateNormalDiag"
        q_inv = self._diag_recip(other.scale)
        trace_term = nn.reduce_sum(q_inv * self.scale)
        gap = other.loc - self.loc
        maha = nn.matmul(nn.matmul(gap, q_inv), gap)
        k = int(self.scale.shape[0])
        log_det_ratio = (nn.log(self._diag_prod(other.scale))
                         - nn.log(self._diag_prod(self.scale)))
        return 0.5 * (trace_term + maha - k + log_det_ratio)
