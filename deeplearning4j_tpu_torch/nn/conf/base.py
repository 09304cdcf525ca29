"""Layer config base, layer registry, and the JSON codec.

A layer is one dataclass that is at once its hyperparameter record (the
`__layer__` JSON form of `deeplearning4j_tpu/nn/conf/base.py`, read and
written identically), its parameter initializer (`init_params(gen, it,
device)` returns a dict of tensors keyed as in JAX) and its forward
(`apply(params, state, x, train=False, generator=None, mask=None) -> (y,
state)`, a plain function of tensors that autograd differentiates).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Dict, Optional

import torch

from .input_type import InputType
from .. import activations as _activations
from .. import updaters as _updaters
from ..schedules import Schedule
from ..weights import Distribution, WeightInit, init_weight

__all__ = ["LayerConf", "register_layer", "conf_to_dict", "conf_from_dict",
           "LAYER_REGISTRY", "cast_floating"]

LAYER_REGISTRY: Dict[str, type] = {}


def register_layer(cls):
    """Class decorator: registers a layer config under its class name for
    the JSON round-trip."""
    LAYER_REGISTRY[cls.__name__] = cls
    return cls


def cast_floating(tree, dtype: torch.dtype):
    """Cast every floating-point tensor of a (nested) dict to `dtype` (the
    mixed-precision compute cast; integer tensors untouched). Through
    autograd, so the cast's gradient comes back in the master dtype."""
    if isinstance(tree, dict):
        return {k: cast_floating(v, dtype) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor) and tree.is_floating_point():
        return tree.to(dtype)
    return tree


def conf_to_dict(obj: Any) -> Any:
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return obj
    if isinstance(obj, _updaters.Updater):
        return {"__updater__": obj.to_dict()}
    if isinstance(obj, Distribution):
        return {"__distribution__": obj.to_dict()}
    if isinstance(obj, Schedule):
        return {"__schedule__": obj.to_dict()}
    if isinstance(obj, InputType):
        return {"__input_type__": obj.to_dict()}
    if isinstance(obj, LayerConf):
        return {"__layer__": {"type": type(obj).__name__,
                              "fields": {f.name: conf_to_dict(getattr(obj, f.name))
                                         for f in dataclasses.fields(obj)}}}
    if isinstance(obj, (list, tuple)):
        return [conf_to_dict(x) for x in obj]
    if isinstance(obj, dict):
        return {str(k): conf_to_dict(v) for k, v in obj.items()}
    raise TypeError(f"Cannot serialize config value of type {type(obj)}: {obj!r}")


def conf_from_dict(obj: Any) -> Any:
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return obj
    if isinstance(obj, list):
        return [conf_from_dict(x) for x in obj]
    if isinstance(obj, dict):
        if "__updater__" in obj:
            return _updaters.from_dict(obj["__updater__"])
        if "__distribution__" in obj:
            return Distribution.from_dict(obj["__distribution__"])
        if "__schedule__" in obj:
            return Schedule.from_dict(obj["__schedule__"])
        if "__input_type__" in obj:
            return InputType.from_dict(obj["__input_type__"])
        if "__layer__" in obj:
            spec = obj["__layer__"]
            cls = LAYER_REGISTRY.get(spec["type"])
            if cls is None:
                raise ValueError(
                    f"Unknown layer type '{spec['type']}' in config (the "
                    f"PyTorch port has {sorted(LAYER_REGISTRY)})")
            fields = {k: conf_from_dict(v) for k, v in spec["fields"].items()}
            known = {f.name for f in dataclasses.fields(cls)}
            return cls(**{k: v for k, v in fields.items() if k in known})
        if "__dataclass__" in obj:
            raise ValueError(f"Unknown aux dataclass "
                             f"'{obj['__dataclass__']['type']}' in config")
        return {k: conf_from_dict(v) for k, v in obj.items()}
    raise TypeError(f"Cannot deserialize config value {obj!r}")


@dataclass
class LayerConf:
    """Hyperparameters shared by all layers. Left as None, an inheritable
    field takes the network's global value at build time."""

    # expected input family for shape inference: "ff"|"cnn"|"rnn"|"any"
    input_kind = "ff"

    name: Optional[str] = None
    activation: Optional[str] = None
    weight_init: Optional[str] = None
    dist: Optional[Distribution] = None
    bias_init: Optional[float] = None
    updater: Optional[_updaters.Updater] = None
    learning_rate: Optional[float] = None
    bias_learning_rate: Optional[float] = None
    l1: Optional[float] = None
    l2: Optional[float] = None
    l1_bias: Optional[float] = None
    l2_bias: Optional[float] = None
    dropout: Optional[float] = None
    dtype: Optional[str] = None
    frozen: bool = False
    gradient_normalization: Optional[str] = None
    gradient_normalization_threshold: Optional[float] = None
    activation_store_dtype: Optional[str] = None
    remat_policy: Optional[str] = None

    # ---- shape inference -------------------------------------------------
    def output_type(self, input_type: InputType) -> InputType:
        return input_type

    def n_in_from(self, input_type: InputType) -> int:
        return input_type.flat_size()

    # ---- params ----------------------------------------------------------
    @property
    def has_params(self) -> bool:
        return False

    def init_params(self, gen: torch.Generator, input_type: InputType,
                    device: torch.device) -> Dict[str, torch.Tensor]:
        return {}

    def init_state(self, input_type: InputType,
                   device: torch.device) -> Dict[str, torch.Tensor]:
        """Non-trained layer state (BatchNormalization's running stats)."""
        return {}

    # ---- forward ---------------------------------------------------------
    def apply(self, params, state, x, *, train=False, generator=None,
              mask=None):
        raise NotImplementedError(type(self).__name__)

    def output_mask(self, mask):
        return mask

    # ---- regularization contribution ------------------------------------
    def reg_score(self, params) -> torch.Tensor:
        """L1/L2 penalty for this layer's params, with the weight / bias
        split of JAX `LayerConf.reg_score`."""
        score = torch.zeros((), dtype=torch.float32,
                            device=next(iter(params.values())).device)
        for k, v in params.items():
            is_bias = k == "b" or k.endswith("_b") or "bias" in k
            l1 = (self.l1_bias if is_bias else self.l1) or 0.0
            l2 = (self.l2_bias if is_bias else self.l2) or 0.0
            if l1:
                score = score + l1 * v.abs().sum()
            if l2:
                score = score + 0.5 * l2 * (v * v).sum()
        return score

    # ---- helpers ---------------------------------------------------------
    def _act(self, x):
        return _activations.get(self.activation or "identity")(x)

    def _param_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype or "float32")

    def _winit(self, gen, shape, fan_in, fan_out, device):
        return init_weight(gen, shape, self.weight_init or WeightInit.XAVIER,
                           fan_in=fan_in, fan_out=fan_out,
                           distribution=self.dist,
                           dtype=self._param_dtype()).to(device)

    def _binit(self, shape, device):
        return torch.full(shape, self.bias_init or 0.0,
                          dtype=self._param_dtype(), device=device)

    def maybe_dropout_input(self, x, train, generator):
        """Inverted dropout of the layer's input while training (`dropout`
        is the retain probability), from an explicit generator. Its random
        stream is not `jax.random`'s, so only dropout-free runs compare
        with JAX value for value."""
        if (not train or not self.dropout or self.dropout >= 1.0
                or generator is None):
            return x
        keep = self.dropout
        u = torch.rand(x.shape, generator=generator, dtype=x.dtype,
                       device=generator.device).to(x.device)
        return torch.where(u < keep, x / keep, torch.zeros_like(x))
