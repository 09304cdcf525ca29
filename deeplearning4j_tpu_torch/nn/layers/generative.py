"""Generative and pretraining layers: AutoEncoder, RBM,
VariationalAutoencoder (with its reconstruction distributions) and
CenterLossOutputLayer, the port of
`deeplearning4j_tpu/nn/layers/generative.py`.

Pretraining protocol (`MultiLayerNetwork.pretrain`):

    layer.is_pretrainable -> True
    layer.pretrain_value_and_grad(params, x, generator) -> (score, grads)

The AutoEncoder's and the VAE's gradients come from autograd of their
losses; the RBM's are the contrastive-divergence (CD-k) difference of the
positive and negative phases, computed directly as in JAX. Every random
draw (corruption mask, Gibbs samples, reparameterization noise) goes
through `nn.noise.draw`. In a supervised network the AutoEncoder and the
RBM output their hidden activations, the VAE its latent mean.

CenterLossOutputLayer adds lambda/2 ||x - c_y||^2 to its softmax loss; the
centers train by gradient descent on the same term scaled by `alpha` (the
JAX package's form).
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from .. import activations as _activations
from .. import losses as _losses
from .. import noise as _noise
from ..conf.base import LayerConf, register_aux_dataclass, register_layer
from ..conf.input_type import InputType
from ..trees import flat_leaves, tree_map
from .feedforward import BaseOutputLayerConf

__all__ = [
    "AutoEncoder", "RBM", "VariationalAutoencoder", "CenterLossOutputLayer",
    "GaussianReconstructionDistribution",
    "BernoulliReconstructionDistribution",
    "CompositeReconstructionDistribution", "LossFunctionWrapper",
]


def _value_and_grad(loss, params):
    """(loss(params), d loss / d params) with autograd, on a detached copy
    of the parameter tree."""
    p = tree_map(lambda v: v.detach().requires_grad_(True), params)
    leaves = flat_leaves(p)
    with torch.enable_grad():
        value = loss(p)
        grads = torch.autograd.grad(value, leaves, allow_unused=True)
    by_leaf = {id(v): g for v, g in zip(leaves, grads)}
    return value.detach(), tree_map(
        lambda v: torch.zeros_like(v) if by_leaf[id(v)] is None
        else by_leaf[id(v)], p)


def _bernoulli(p, generator, like):
    """Bernoulli(p) draws as `like`'s dtype: uniform < p."""
    return (_noise.draw("uniform", like.shape, generator, like.dtype,
                        like.device) < p).to(like.dtype)


# ---------------------------------------------------------------------------
# AutoEncoder
# ---------------------------------------------------------------------------

@register_layer
@dataclass
class AutoEncoder(LayerConf):
    """Denoising autoencoder: corruption, W / hidden bias `b` / visible
    bias `vb`, decoding through W^T."""

    n_in: Optional[int] = None
    n_out: int = 0
    corruption_level: float = 0.3
    sparsity: float = 0.0
    pretrain_loss: str = "mse"

    def __post_init__(self):
        if self.activation is None:
            self.activation = "sigmoid"

    def output_type(self, it: InputType) -> InputType:
        return InputType.feed_forward(self.n_out)

    @property
    def has_params(self) -> bool:
        return True

    @property
    def is_pretrainable(self) -> bool:
        return True

    def init_params(self, gen, it: InputType, device):
        n_in = self.n_in or it.flat_size()
        return {"W": self._winit(gen, (n_in, self.n_out), fan_in=n_in,
                                 fan_out=self.n_out, device=device),
                "b": self._binit((self.n_out,), device),
                "vb": self._binit((n_in,), device)}

    def encode(self, params, x):
        return self._act(x @ params["W"] + params["b"])

    def decode(self, params, h):
        return self._act(h @ params["W"].T + params["vb"])

    def apply(self, params, state, x, *, train=False, generator=None,
              mask=None):
        x = self.maybe_dropout_input(x, train, generator)
        return self.encode(params, x), state

    def pretrain_value_and_grad(self, params, x, generator):
        xin = x
        if self.corruption_level > 0 and generator is not None:
            u = _noise.draw("uniform", x.shape, generator, x.dtype, x.device)
            xin = torch.where(u < 1.0 - self.corruption_level, x,
                              torch.zeros_like(x))

        def loss(p):
            h = self.encode(p, xin)
            recon = self.decode(p, h)
            score = _losses.get(self.pretrain_loss).score(
                x, recon, activation="identity")
            if self.sparsity > 0:
                rho_hat = torch.clamp(h.mean(dim=0), 1e-6, 1 - 1e-6)
                rho = self.sparsity
                score = score + torch.sum(
                    rho * torch.log(rho / rho_hat)
                    + (1 - rho) * torch.log((1 - rho) / (1 - rho_hat)))
            return score
        return _value_and_grad(loss, params)


# ---------------------------------------------------------------------------
# RBM
# ---------------------------------------------------------------------------

@register_layer
@dataclass
class RBM(LayerConf):
    """Restricted Boltzmann machine with CD-k pretraining."""

    n_in: Optional[int] = None
    n_out: int = 0
    hidden_unit: str = "binary"    # binary | rectified | gaussian
    visible_unit: str = "binary"   # binary | gaussian
    k: int = 1                     # CD-k Gibbs steps

    def __post_init__(self):
        if self.activation is None:
            self.activation = "sigmoid"

    def output_type(self, it: InputType) -> InputType:
        return InputType.feed_forward(self.n_out)

    @property
    def has_params(self) -> bool:
        return True

    @property
    def is_pretrainable(self) -> bool:
        return True

    def init_params(self, gen, it: InputType, device):
        n_in = self.n_in or it.flat_size()
        return {"W": self._winit(gen, (n_in, self.n_out), fan_in=n_in,
                                 fan_out=self.n_out, device=device),
                "b": self._binit((self.n_out,), device),      # hidden bias
                "vb": self._binit((n_in,), device)}           # visible bias

    def _prop_up(self, params, v):
        pre = v @ params["W"] + params["b"]
        if self.hidden_unit == "rectified":
            return torch.relu(pre)
        return torch.sigmoid(pre)

    def _prop_down(self, params, h):
        pre = h @ params["W"].T + params["vb"]
        if self.visible_unit == "gaussian":
            return pre
        return torch.sigmoid(pre)

    def apply(self, params, state, x, *, train=False, generator=None,
              mask=None):
        x = self.maybe_dropout_input(x, train, generator)
        return self._prop_up(params, x), state

    def pretrain_value_and_grad(self, params, x, generator):
        """CD-k in descent form: grads = -(positive - negative phase). The
        score is the reconstruction's squared error, summed over features
        and averaged over rows."""
        with torch.no_grad():
            batch = x.shape[0]
            h_prob = self._prop_up(params, x)
            h_neg = (_bernoulli(h_prob, generator, h_prob)
                     if self.hidden_unit == "binary" else h_prob)
            v_neg = x
            for _ in range(self.k):
                v_neg = self._prop_down(params, h_neg)
                if self.visible_unit == "binary":
                    v_neg = _bernoulli(v_neg, generator, v_neg)
                h_neg = self._prop_up(params, v_neg)
            grads = {"W": -(x.T @ h_prob - v_neg.T @ h_neg) / batch,
                     "b": -(h_prob - h_neg).mean(dim=0),
                     "vb": -(x - v_neg).mean(dim=0)}
            recon = self._prop_down(params, h_prob)
            score = ((x - recon) ** 2).sum(dim=-1).mean()
        return score, grads


# ---------------------------------------------------------------------------
# VAE reconstruction distributions
# ---------------------------------------------------------------------------

@register_aux_dataclass
@dataclass
class GaussianReconstructionDistribution:
    """p(x|z) = N(mean, sigma^2); two distribution parameters per feature:
    [mean, log sigma^2]."""

    activation: str = "identity"

    params_per_feature = 2

    def log_prob(self, x, dist_params):
        n = x.shape[-1]
        mean = _activations.get(self.activation)(dist_params[..., :n])
        log_var = dist_params[..., n:]
        return torch.sum(-0.5 * (math.log(2 * math.pi) + log_var
                                 + (x - mean) ** 2 / torch.exp(log_var)),
                         dim=-1)

    def sample_mean(self, dist_params, n):
        return _activations.get(self.activation)(dist_params[..., :n])


@register_aux_dataclass
@dataclass
class BernoulliReconstructionDistribution:
    """p(x|z) = Bernoulli(sigmoid(logits))."""

    activation: str = "sigmoid"

    params_per_feature = 1

    def log_prob(self, x, dist_params):
        return torch.sum(x * F.logsigmoid(dist_params)
                         + (1 - x) * F.logsigmoid(-dist_params), dim=-1)

    def sample_mean(self, dist_params, n):
        return torch.sigmoid(dist_params)


@register_aux_dataclass
@dataclass
class CompositeReconstructionDistribution:
    """Distributions over consecutive feature ranges: `sizes[i]` features
    follow `dists[i]`."""

    sizes: Sequence[int] = ()
    dists: Sequence[object] = ()

    @property
    def params_per_feature(self):
        raise AttributeError("composite: use total_params")

    def total_params(self, n_features):
        if sum(self.sizes) != n_features:
            raise ValueError(f"composite sizes {list(self.sizes)} do not "
                             f"add up to {n_features} features")
        return sum(int(s) * d.params_per_feature
                   for s, d in zip(self.sizes, self.dists))

    def _parts(self):
        xi = pi = 0
        for s, d in zip(self.sizes, self.dists):
            n_p = s * d.params_per_feature
            yield d, s, slice(xi, xi + s), slice(pi, pi + n_p)
            xi += s
            pi += n_p

    def log_prob(self, x, dist_params):
        lp = 0.0
        for d, _, xs, ps in self._parts():
            lp = lp + d.log_prob(x[..., xs], dist_params[..., ps])
        return lp

    def sample_mean(self, dist_params, n):
        return torch.cat([d.sample_mean(dist_params[..., ps], s)
                          for d, s, _, ps in self._parts()], dim=-1)


@register_aux_dataclass
@dataclass
class LossFunctionWrapper:
    """A plain loss as the reconstruction term: log p = -loss."""

    loss: str = "mse"
    activation: str = "identity"

    params_per_feature = 1

    def log_prob(self, x, dist_params):
        return -_losses.get(self.loss).per_example(
            x, dist_params, activation=self.activation)

    def sample_mean(self, dist_params, n):
        return _activations.get(self.activation)(dist_params)


# ---------------------------------------------------------------------------
# Variational autoencoder
# ---------------------------------------------------------------------------

@register_layer
@dataclass
class VariationalAutoencoder(LayerConf):
    """VAE pretraining layer: encoder MLP -> (mean, log variance) of z,
    decoder MLP -> the reconstruction distribution's parameters; the
    pretraining loss is the negative ELBO. In a supervised network `apply`
    outputs the latent mean."""

    n_in: Optional[int] = None
    n_out: int = 0                       # latent size
    encoder_layer_sizes: Sequence[int] = (100,)
    decoder_layer_sizes: Sequence[int] = (100,)
    reconstruction_distribution: object = field(
        default_factory=BernoulliReconstructionDistribution)
    pzx_activation: str = "identity"
    num_samples: int = 1

    def __post_init__(self):
        if self.activation is None:
            self.activation = "tanh"     # the hidden layers' activation

    def output_type(self, it: InputType) -> InputType:
        return InputType.feed_forward(self.n_out)

    @property
    def has_params(self) -> bool:
        return True

    @property
    def is_pretrainable(self) -> bool:
        return True

    def _recon_params_count(self, n_in):
        d = self.reconstruction_distribution
        if isinstance(d, CompositeReconstructionDistribution):
            return d.total_params(n_in)
        return n_in * d.params_per_feature

    def init_params(self, gen, it: InputType, device):
        n_in = self.n_in or it.flat_size()
        sizes_e = [n_in] + list(self.encoder_layer_sizes)
        sizes_d = [self.n_out] + list(self.decoder_layer_sizes)
        n_recon = self._recon_params_count(n_in)
        w = lambda a, b: self._winit(gen, (a, b), fan_in=a, fan_out=b,
                                     device=device)
        p = {}
        for i in range(len(sizes_e) - 1):
            p[f"eW{i}"] = w(sizes_e[i], sizes_e[i + 1])
            p[f"eb{i}"] = self._binit((sizes_e[i + 1],), device)
        p["zW"] = w(sizes_e[-1], 2 * self.n_out)
        p["zb"] = self._binit((2 * self.n_out,), device)
        for i in range(len(sizes_d) - 1):
            p[f"dW{i}"] = w(sizes_d[i], sizes_d[i + 1])
            p[f"db{i}"] = self._binit((sizes_d[i + 1],), device)
        p["xW"] = w(sizes_d[-1], n_recon)
        p["xb"] = self._binit((n_recon,), device)
        return p

    def _encode(self, params, x):
        h = x
        for i in range(len(self.encoder_layer_sizes)):
            h = self._act(h @ params[f"eW{i}"] + params[f"eb{i}"])
        mean, log_var = torch.chunk(h @ params["zW"] + params["zb"], 2,
                                    dim=-1)
        return _activations.get(self.pzx_activation)(mean), log_var

    def _decode(self, params, z):
        h = z
        for i in range(len(self.decoder_layer_sizes)):
            h = self._act(h @ params[f"dW{i}"] + params[f"db{i}"])
        return h @ params["xW"] + params["xb"]

    def _sample_z(self, mean, log_var, generator):
        eps = _noise.draw("normal", mean.shape, generator, mean.dtype,
                          mean.device)
        return mean + torch.exp(0.5 * log_var) * eps

    def apply(self, params, state, x, *, train=False, generator=None,
              mask=None):
        x = self.maybe_dropout_input(x, train, generator)
        return self._encode(params, x)[0], state

    def pretrain_value_and_grad(self, params, x, generator):
        # the reparameterization noise: it does not depend on the params
        eps = [_noise.draw("normal", (x.shape[0], self.n_out), generator,
                           x.dtype, x.device)
               for _ in range(self.num_samples)]

        def loss(p):
            mean, log_var = self._encode(p, x)
            kl = -0.5 * torch.sum(1 + log_var - mean ** 2
                                  - torch.exp(log_var), dim=-1)
            rec = 0.0
            for e in eps:
                z = mean + torch.exp(0.5 * log_var) * e
                rec = rec + self.reconstruction_distribution.log_prob(
                    x, self._decode(p, z))
            return torch.mean(kl - rec / self.num_samples)   # -ELBO
        return _value_and_grad(loss, params)

    def reconstruction_probability(self, params, x, generator,
                                   num_samples: int = 5):
        """Importance-sampled log p(x) estimate per example (the VAE
        anomaly score): logsumexp over `num_samples` decodes, less log
        num_samples."""
        mean, log_var = self._encode(params, x)
        lps = [self.reconstruction_distribution.log_prob(
            x, self._decode(params, self._sample_z(mean, log_var,
                                                   generator)))
            for _ in range(num_samples)]
        return (torch.logsumexp(torch.stack(lps), dim=0)
                - math.log(float(num_samples)))

    def generate_at_mean_given_z(self, params, z):
        return self.reconstruction_distribution.sample_mean(
            self._decode(params, z), self.n_in)


# ---------------------------------------------------------------------------
# Center loss
# ---------------------------------------------------------------------------

@register_layer
@dataclass
class CenterLossOutputLayer(BaseOutputLayerConf):
    n_in: Optional[int] = None
    n_out: int = 0
    has_bias: bool = True
    alpha: float = 0.05       # the centers' learning-rate scale
    lambda_: float = 2e-4     # the center term's weight

    def __post_init__(self):
        if self.activation is None:
            self.activation = "softmax"

    def output_type(self, it: InputType) -> InputType:
        return InputType.feed_forward(self.n_out)

    @property
    def has_params(self) -> bool:
        return True

    def init_params(self, gen, it: InputType, device):
        n_in = self.n_in or it.flat_size()
        p = {"W": self._winit(gen, (n_in, self.n_out), fan_in=n_in,
                              fan_out=self.n_out, device=device),
             "centers": torch.zeros((self.n_out, n_in), dtype=torch.float32,
                                    device=device)}
        if self.has_bias:
            p["b"] = self._binit((self.n_out,), device)
        return p

    def preout(self, params, state, x, *, train=False, generator=None,
               mask=None):
        x = self.maybe_dropout_input(x, train, generator)
        z = x @ params["W"]
        if self.has_bias:
            z = z + params["b"]
        return z

    def loss_score(self, params, state, x, labels, *, train=False,
                   generator=None, mask=None):
        base = super().loss_score(params, state, x, labels, train=train,
                                  generator=generator, mask=mask)
        c_y = params["centers"][labels.argmax(dim=-1)]
        # the features see the whole center term; the centers' gradient is
        # the same term's scaled by alpha, through a term of value 0
        center = 0.5 * self.lambda_ * torch.mean(
            torch.sum((x - c_y.detach()) ** 2, dim=-1))
        cgrad = 0.5 * self.lambda_ * self.alpha * torch.mean(
            torch.sum((x.detach() - c_y) ** 2, dim=-1))
        return base + center + (cgrad - cgrad.detach())
