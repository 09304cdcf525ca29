"""PyTorch port, the zoo's benches (`deeplearning4j_tpu_torch/models/zoo.py`
`bench_*`, the measured forms of BASELINE configs 1-3) on the CPU at tiny
sizes, held against the JAX package's.

Each bench keeps the JAX function's defaults (plus `device`) and returns
JAX's label, or a dict with JAX's keys. The LeNet and char-RNN benches run
in both packages at the same tiny sizes; the ragged and superstep benches'
compile counts, pipeline rows and padding fractions equal JAX's (a compile
in the port is the first call of a batch signature on the CPU, a CUDA-graph
capture on the card). JAX's ResNet-50 bench is not compiled here: its label
is read from its source.
"""
import inspect

import numpy as np
import pytest

from deeplearning4j_tpu.models import zoo as jzoo
from deeplearning4j_tpu_torch.models import zoo as pzoo
from torch_threads import one_torch_thread  # noqa: F401

BENCHES = ("bench_lenet", "bench_lenet_dispatch", "bench_char_rnn",
           "bench_char_rnn_dispatch", "bench_resnet50", "bench_lenet_ragged",
           "bench_lenet_superstep")
TINY = {
    "bench_lenet": dict(batch=8, steps=3),
    "bench_lenet_dispatch": dict(batch=8, steps=3, warmup=1),
    "bench_char_rnn": dict(batch=2, seq_len=16, steps=2),
    "bench_char_rnn_dispatch": dict(batch=2, seq_len=16, steps=2, warmup=1),
}


def _keys(tree):
    """The nested key structure of a bench's dict."""
    if isinstance(tree, dict):
        return {k: _keys(v) for k, v in tree.items()}
    return type(tree).__name__


@pytest.mark.parametrize("name", BENCHES + ("_paired_superstep",))
def test_bench_signatures_are_jax_plus_device(name):
    jsig = inspect.signature(getattr(jzoo, name)).parameters
    psig = inspect.signature(getattr(pzoo, name)).parameters
    want = [(k, p.default) for k, p in jsig.items()]
    got = [(k, p.default) for k, p in psig.items() if k != "device"]
    assert got == want
    if name != "_paired_superstep":
        assert list(psig)[-1] == "device" and psig["device"].default is None
        assert name in pzoo.__all__


@pytest.mark.parametrize("name", sorted(TINY))
def test_value_bench_returns_jax_label(name):
    value, label = getattr(pzoo, name)(device="cpu", **TINY[name])
    jvalue, jlabel = getattr(jzoo, name)(**TINY[name])
    assert label == jlabel
    assert np.isfinite(value) and value > 0 and jvalue > 0


def test_resnet50_bench_returns_jax_label():
    value, label = pzoo.bench_resnet50(batch=2, steps=2, image=32,
                                       n_classes=10, device="cpu")
    assert np.isfinite(value) and value > 0
    assert f'"{label}"' in inspect.getsource(jzoo.bench_resnet50)
    assert label == "ResNet50-ImageNet"


def test_lenet_ragged_bench_has_jax_keys_and_counts():
    kw = dict(batch=8, full_batches=2, ragged=5, epochs=1)
    got = pzoo.bench_lenet_ragged(device="cpu", **kw)
    want = jzoo.bench_lenet_ragged(**kw)
    assert _keys(got) == _keys(want)
    for name in ("serial", "padded", "padded_prefetch"):
        assert got[name]["train_step_compiles"] == \
            want[name]["train_step_compiles"]
        for key in ("rows", "pad_fraction", "prefetch_waits"):
            assert got[name].get("pipeline", {}).get(key) == \
                want[name].get("pipeline", {}).get(key)
    assert [got[n]["train_step_compiles"] for n in
            ("serial", "padded", "padded_prefetch")] == [2, 1, 1]


def test_lenet_superstep_bench_has_jax_keys_and_counts():
    kw = dict(batch=8, n_batches=4, epochs=1)
    got = pzoo.bench_lenet_superstep(device="cpu", **kw)
    want = jzoo.bench_lenet_superstep(**kw)
    assert _keys(got) == _keys(want)
    for part in (got, got["mlp128"]):
        wpart = want if part is got else want["mlp128"]
        assert part["superstep_k"] == wpart["superstep_k"]
        for name in ("perbatch", "superstep"):
            for key in ("superstep_compiles", "train_step_compiles"):
                assert part[name][key] == wpart[name][key]
        assert len(part["paired_ratios"]) == 3


def test_benches_default_to_the_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        pzoo.bench_lenet(batch=8, steps=1)
