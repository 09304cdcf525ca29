"""Network configuration DSL: `NeuralNetConfiguration.builder()...list()
...build()` and `MultiLayerConfiguration.to_json/from_json`, reading and
writing the same `configuration.json` as `deeplearning4j_tpu/nn/conf`.

Training settings (updater, regularization, TBPTT lengths, remat, ...) are
carried as configuration data only. Input preprocessors are not in the port
yet: a configuration that needs one raises a named ValueError.
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field, replace
from typing import Dict, List, Optional

from .base import LayerConf, conf_from_dict, conf_to_dict
from .input_type import InputType
from .. import updaters as _updaters
from ..schedules import Schedule
from ..weights import Distribution, WeightInit

__all__ = [
    "NeuralNetConfiguration", "NeuralNetConfigurationBuilder",
    "MultiLayerConfiguration", "ListBuilder", "BackpropType",
    "GradientNormalization", "OptimizationAlgorithm", "InputType",
    "LayerConf",
]

REMAT_POLICIES = ("nothing", "dots", "dots_no_batch", "everything")


class BackpropType:
    STANDARD = "standard"
    TRUNCATED_BPTT = "truncated_bptt"


class GradientNormalization:
    NONE = "none"
    RENORMALIZE_L2_PER_LAYER = "renormalize_l2_per_layer"
    RENORMALIZE_L2_PER_PARAM_TYPE = "renormalize_l2_per_param_type"
    CLIP_ELEMENTWISE_ABSOLUTE_VALUE = "clip_elementwise_absolute_value"
    CLIP_L2_PER_LAYER = "clip_l2_per_layer"
    CLIP_L2_PER_PARAM_TYPE = "clip_l2_per_param_type"


class OptimizationAlgorithm:
    STOCHASTIC_GRADIENT_DESCENT = "sgd"
    LINE_GRADIENT_DESCENT = "line_gradient_descent"
    CONJUGATE_GRADIENT = "conjugate_gradient"
    LBFGS = "lbfgs"


@dataclass
class NeuralNetConfiguration:
    """Global (inheritable) configuration; same fields, in the same order,
    as the JAX package's."""

    seed: int = 12345
    updater: _updaters.Updater = field(default_factory=lambda: _updaters.Sgd(0.1))
    weight_init: str = WeightInit.XAVIER
    dist: Optional[Distribution] = None
    activation: Optional[str] = None
    bias_init: float = 0.0
    l1: float = 0.0
    l2: float = 0.0
    l1_bias: float = 0.0
    l2_bias: float = 0.0
    use_regularization: bool = False
    dropout: Optional[float] = None
    lr_schedule: Optional[Schedule] = None
    gradient_normalization: str = GradientNormalization.NONE
    gradient_normalization_threshold: float = 1.0
    optimization_algo: str = OptimizationAlgorithm.STOCHASTIC_GRADIENT_DESCENT
    max_num_line_search_iterations: int = 5
    minimize: bool = True
    mini_batch: bool = True
    dtype: str = "float32"
    compute_dtype: Optional[str] = None
    activation_store_dtype: Optional[str] = None
    remat: Optional[str] = None
    remat_policy: Optional[str] = None

    @staticmethod
    def builder() -> "NeuralNetConfigurationBuilder":
        return NeuralNetConfigurationBuilder()

    def resolve_layer(self, layer: LayerConf) -> LayerConf:
        """Fill the layer's unset inheritable fields from the globals."""
        reg = self.use_regularization
        ov = {}
        if layer.activation is None and self.activation is not None:
            ov["activation"] = self.activation
        if layer.weight_init is None:
            ov["weight_init"] = self.weight_init
        if layer.dist is None and self.dist is not None:
            ov["dist"] = self.dist
        if layer.bias_init is None:
            ov["bias_init"] = self.bias_init
        if layer.updater is None:
            ov["updater"] = self.updater
        for name in ("l1", "l2", "l1_bias", "l2_bias"):
            if getattr(layer, name) is None:
                ov[name] = getattr(self, name) if reg else 0.0
        if layer.dropout is None and self.dropout is not None and reg:
            ov["dropout"] = self.dropout
        if layer.dtype is None:
            ov["dtype"] = self.dtype
        if (layer.activation_store_dtype is None
                and self.activation_store_dtype is not None):
            ov["activation_store_dtype"] = self.activation_store_dtype
        if layer.remat_policy is None and self.remat_policy is not None:
            ov["remat_policy"] = self.remat_policy
        if layer.gradient_normalization is None:
            ov["gradient_normalization"] = self.gradient_normalization
        if layer.gradient_normalization_threshold is None:
            ov["gradient_normalization_threshold"] = \
                self.gradient_normalization_threshold
        return replace(layer, **ov) if ov else layer

    def to_dict(self):
        return {k: conf_to_dict(getattr(self, k)) for k in self.__dataclass_fields__}

    @staticmethod
    def from_dict(d) -> "NeuralNetConfiguration":
        known = NeuralNetConfiguration.__dataclass_fields__
        return NeuralNetConfiguration(
            **{k: conf_from_dict(v) for k, v in d.items() if k in known})


class NeuralNetConfigurationBuilder:
    """Fluent builder mirroring `NeuralNetConfiguration.Builder`."""

    def __init__(self):
        self._c = NeuralNetConfiguration()

    def seed(self, s):
        self._c.seed = int(s); return self

    def updater(self, u, learning_rate=None):
        self._c.updater = _updaters.get(u, learning_rate); return self

    def learning_rate(self, lr):
        u = self._c.updater
        if "learning_rate" in u.__dataclass_fields__:
            self._c.updater = replace(u, learning_rate=float(lr))
        return self

    def learning_rate_decay_policy(self, policy, decay_rate=0.0, steps=1.0,
                                   power=1.0, max_iter=10000.0, schedule=None):
        base = getattr(self._c.updater, "learning_rate", 0.1)
        self._c.lr_schedule = Schedule(base_lr=base, policy=policy,
                                       decay_rate=decay_rate, steps=steps,
                                       power=power, max_iter=max_iter,
                                       schedule=schedule)
        return self

    def weight_init(self, w):
        self._c.weight_init = w; return self

    def dist(self, d: Distribution):
        self._c.dist = d
        self._c.weight_init = WeightInit.DISTRIBUTION
        return self

    def activation(self, a):
        self._c.activation = a; return self

    def bias_init(self, b):
        self._c.bias_init = float(b); return self

    def regularization(self, use: bool = True):
        self._c.use_regularization = bool(use); return self

    def l1(self, v):
        self._c.l1 = float(v); self._c.use_regularization = True; return self

    def l2(self, v):
        self._c.l2 = float(v); self._c.use_regularization = True; return self

    def l1_bias(self, v):
        self._c.l1_bias = float(v); self._c.use_regularization = True; return self

    def l2_bias(self, v):
        self._c.l2_bias = float(v); self._c.use_regularization = True; return self

    def dropout(self, retain_prob):
        self._c.dropout = float(retain_prob); return self

    def gradient_normalization(self, gn, threshold=None):
        self._c.gradient_normalization = gn
        if threshold is not None:
            self._c.gradient_normalization_threshold = float(threshold)
        return self

    def optimization_algo(self, algo):
        self._c.optimization_algo = algo; return self

    def max_num_line_search_iterations(self, n):
        self._c.max_num_line_search_iterations = int(n); return self

    def minimize(self, m: bool = True):
        self._c.minimize = bool(m); return self

    def dtype(self, dt):
        self._c.dtype = str(dt); return self

    def compute_dtype(self, dt):
        self._c.compute_dtype = None if dt is None else str(dt); return self

    def activation_store_dtype(self, dt):
        self._c.activation_store_dtype = None if dt is None else str(dt)
        return self

    def remat(self, mode):
        if mode is not None and mode not in ("full", "layer", "blocks"):
            raise ValueError(f"remat must be None|'full'|'layer'|'blocks', got {mode!r}")
        self._c.remat = mode; return self

    def remat_policy(self, name):
        if name is not None and name not in REMAT_POLICIES:
            raise ValueError(f"unknown remat policy {name!r}; expected one of "
                             f"{REMAT_POLICIES}")
        self._c.remat_policy = name; return self

    def build(self) -> NeuralNetConfiguration:
        return self._c

    def list(self) -> "ListBuilder":
        return ListBuilder(self._c)


@dataclass
class MultiLayerConfiguration:
    """Sequential network config."""

    conf: NeuralNetConfiguration
    layers: List[LayerConf] = field(default_factory=list)
    input_type: Optional[InputType] = None
    preprocessors: Dict[int, object] = field(default_factory=dict)
    backprop: bool = True
    pretrain: bool = False
    backprop_type: str = BackpropType.STANDARD
    tbptt_fwd_length: int = 20
    tbptt_back_length: int = 20

    def to_json(self) -> str:
        return json.dumps({
            "conf": self.conf.to_dict(),
            "layers": [conf_to_dict(l) for l in self.layers],
            "input_type": conf_to_dict(self.input_type),
            "preprocessors": {str(k): conf_to_dict(v) for k, v in self.preprocessors.items()},
            "backprop": self.backprop,
            "pretrain": self.pretrain,
            "backprop_type": self.backprop_type,
            "tbptt_fwd_length": self.tbptt_fwd_length,
            "tbptt_back_length": self.tbptt_back_length,
        }, indent=2)

    @staticmethod
    def from_json(s: str) -> "MultiLayerConfiguration":
        d = json.loads(s)
        if d.get("preprocessors"):
            raise ValueError(
                "input preprocessors are not in the PyTorch port yet; this "
                f"configuration declares {sorted(d['preprocessors'])}")
        return MultiLayerConfiguration(
            conf=NeuralNetConfiguration.from_dict(d["conf"]),
            layers=[conf_from_dict(l) for l in d["layers"]],
            input_type=conf_from_dict(d.get("input_type")),
            backprop=d.get("backprop", True),
            pretrain=d.get("pretrain", False),
            backprop_type=d.get("backprop_type", BackpropType.STANDARD),
            tbptt_fwd_length=d.get("tbptt_fwd_length", 20),
            tbptt_back_length=d.get("tbptt_back_length", 20),
        )


class ListBuilder:
    """`.list()` builder."""

    def __init__(self, conf: NeuralNetConfiguration):
        self._conf = conf
        self._layers: List[LayerConf] = []
        self._input_type: Optional[InputType] = None
        self._backprop = True
        self._pretrain = False
        self._bp_type = BackpropType.STANDARD
        self._tbptt_fwd = 20
        self._tbptt_back = 20

    def layer(self, *args):
        """layer(conf) or layer(index, conf)."""
        if len(args) == 1:
            self._layers.append(args[0])
        else:
            idx, conf = args
            while len(self._layers) <= idx:
                self._layers.append(None)
            self._layers[idx] = conf
        return self

    def set_input_type(self, it: InputType):
        self._input_type = it; return self

    def backprop(self, b: bool):
        self._backprop = bool(b); return self

    def pretrain(self, p: bool):
        self._pretrain = bool(p); return self

    def backprop_type(self, t: str):
        self._bp_type = t; return self

    def t_bptt_forward_length(self, n: int):
        self._tbptt_fwd = int(n); return self

    def t_bptt_backward_length(self, n: int):
        self._tbptt_back = int(n); return self

    def build(self) -> MultiLayerConfiguration:
        if any(l is None for l in self._layers):
            raise ValueError("Layer list has gaps")
        layers = [self._conf.resolve_layer(l) for l in self._layers]
        if self._input_type is not None:
            it = self._input_type
            inferred = []
            for i, l in enumerate(layers):
                _check_no_preprocessor(i, it, l)
                l = _fill_n_in(l, it)
                inferred.append(l)
                it = l.output_type(it)
            layers = inferred
        return MultiLayerConfiguration(
            conf=self._conf, layers=layers, input_type=self._input_type,
            backprop=self._backprop, pretrain=self._pretrain,
            backprop_type=self._bp_type, tbptt_fwd_length=self._tbptt_fwd,
            tbptt_back_length=self._tbptt_back,
        )


def _check_no_preprocessor(i: int, it: InputType, layer: LayerConf):
    """Raise where the JAX builder would insert an input preprocessor."""
    want, kind = layer.input_kind, it.kind
    if (want == "any" or kind == want or (want == "ff" and kind == "cnn_flat")
            or (want == "rnn" and kind == "cnn1d")):
        return
    raise ValueError(
        f"layer {i} ({type(layer).__name__}) takes '{want}' input but gets "
        f"'{kind}': that needs an input preprocessor, which the PyTorch port "
        "does not have yet")


def _fill_n_in(layer: LayerConf, input_type: InputType) -> LayerConf:
    """Fill n_in (and a layer's own fields, such as BatchNormalization's
    n_out) from the incoming InputType, as the JAX builder does."""
    updates = {}
    if hasattr(layer, "n_in") and getattr(layer, "n_in") in (None, 0):
        updates["n_in"] = layer.n_in_from(input_type)
    if hasattr(layer, "fill_from_input_type"):
        updates.update(layer.fill_from_input_type(input_type) or {})
    return replace(layer, **updates) if updates else layer
