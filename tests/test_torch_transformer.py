"""PyTorch port, the transformer-LM slice: `gelu`, `EmbeddingSequenceLayer`
ids, `TransformerBlock` (kernel path and masked path) against the JAX
layers on the same numpy parameters, and a small LM (vocab 16, width 32,
4 heads, 2 blocks, T 24) moving between the packages through the config
JSON, the ModelSerializer zip both ways and `from_jax_params`, and served
over HTTP against the JAX `ModelRegistry.predict`.

Tolerance atol 1e-5 unless a test says otherwise: float32 on both sides
(inputs fed to JAX as explicit f32 under the suite's x64), sums of at most
128 terms in another order through LayerNorm, attention and the FFN.
"""
import json
import threading
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.nn.conf import (InputType as JaxInputType,
                                        NeuralNetConfiguration as JaxNNC)
from deeplearning4j_tpu.nn.layers import (
    EmbeddingSequenceLayer as JaxEmbedding, RnnOutputLayer as JaxRnnOutput,
    TransformerBlock as JaxBlock)
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JaxNet
from deeplearning4j_tpu.nn.updaters import Adam as JaxAdam
from deeplearning4j_tpu.serving import ModelRegistry as JaxModelRegistry
from deeplearning4j_tpu.util.serializer import \
    ModelSerializer as JaxModelSerializer
from deeplearning4j_tpu_torch import (Adam, EmbeddingSequenceLayer,
                                      InferenceServer, InputType,
                                      ModelRegistry, ModelSerializer,
                                      MultiLayerConfiguration,
                                      MultiLayerNetwork,
                                      NeuralNetConfiguration, RnnOutputLayer,
                                      TransformerBlock, from_jax_params)
from deeplearning4j_tpu_torch.kernels import attention
from deeplearning4j_tpu_torch.nn import activations
from torch_threads import one_torch_thread  # noqa: F401

ATOL = 1e-5
VOCAB, WIDTH, HEADS, BLOCKS, SEQ = 16, 32, 4, 2, 24


def _lm_conf(nnc, embedding, block, output, input_type, adam, seed=7):
    b = (nnc.builder().seed(seed).updater(adam(1e-3)).list()
         .layer(embedding(n_in=VOCAB, n_out=WIDTH)))
    for _ in range(BLOCKS):
        b = b.layer(block(n_heads=HEADS))
    return (b.layer(output(n_out=VOCAB, activation="softmax", loss="mcxent"))
            .set_input_type(input_type.recurrent(1, SEQ)).build())


def _jax_lm(seed=7):
    return JaxNet(_lm_conf(JaxNNC, JaxEmbedding, JaxBlock, JaxRnnOutput,
                           JaxInputType, JaxAdam, seed)).init()


def _port_lm_conf():
    return _lm_conf(NeuralNetConfiguration, EmbeddingSequenceLayer,
                    TransformerBlock, RnnOutputLayer, InputType, Adam)


def _ids(rows, seed=0):
    r = np.random.default_rng(seed)
    return r.integers(0, VOCAB, (rows, SEQ, 1)).astype(np.float32)


def _block_params(d, seed):
    """The JAX block's parameter dict, drawn with numpy (LN gains and
    biases perturbed so every term matters)."""
    r = np.random.default_rng(seed)
    h = 4 * d
    shapes = {"W_q": (d, d), "W_k": (d, d), "W_v": (d, d), "W_o": (d, d),
              "b_q": (d,), "b_k": (d,), "b_v": (d,), "b_o": (d,),
              "W_ffn_in": (d, h), "b_ffn_in": (h,), "W_ffn_out": (h, d),
              "b_ffn_out": (d,), "ln1_b": (d,), "ln2_b": (d,)}
    p = {k: (r.normal(size=s) / np.sqrt(s[0] if len(s) == 2 else 10))
         .astype(np.float32) for k, s in shapes.items()}
    p["ln1_g"] = (1 + 0.1 * r.normal(size=(d,))).astype(np.float32)
    p["ln2_g"] = (1 + 0.1 * r.normal(size=(d,))).astype(np.float32)
    return p


@pytest.fixture(scope="module")
def jax_zip(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("lm") / "lm.zip")
    JaxModelSerializer.write_model(_jax_lm(), path)
    return path


# ---- activations, embedding, block --------------------------------------

def test_gelu_is_jax_tanh_gelu():
    x = np.linspace(-6, 6, 241).astype(np.float32)
    want = np.asarray(jax.nn.gelu(jnp.asarray(x)))
    got = activations.get("gelu")(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    exact = torch.nn.functional.gelu(torch.from_numpy(x)).numpy()
    assert np.abs(exact - want).max() > 1e-4      # erf form would not pass


def test_embedding_ids_follow_jnp_take():
    """In range, truncated floats, wrapped negatives, NaN (-> id 0) and
    out-of-range ids (-> NaN rows) against `jnp.take` on the JAX layer."""
    d, tmax = 5, 16
    r = np.random.default_rng(3)
    params = {"W": r.normal(size=(VOCAB, d)).astype(np.float32),
              "P": r.normal(size=(tmax, d)).astype(np.float32)}
    ids = np.array([[0, 3.9, 15, -1, -16, -0.5, 2.7, np.nan],
                    [16, -17, 1000, -1e10, 3e9, 1e10, 7, 15.99]],
                   np.float32)[..., None]
    jl = JaxEmbedding(n_in=VOCAB, n_out=d)
    want, _ = jl.apply({k: jnp.asarray(v) for k, v in params.items()}, {},
                       jnp.asarray(ids))
    got, _ = EmbeddingSequenceLayer(n_in=VOCAB, n_out=d).apply(
        {k: torch.from_numpy(v) for k, v in params.items()}, {},
        torch.from_numpy(ids))
    want, got = np.asarray(want), got.numpy()
    assert np.isnan(want).any(axis=-1).tolist() == \
        np.isnan(got).any(axis=-1).tolist()
    assert np.isnan(got[1, :6]).all() and not np.isnan(got[0]).any()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def _block_pair(d, heads, causal, seed):
    p = _block_params(d, seed)
    jblock = JaxBlock(n_model=d, n_heads=heads, causal=causal)
    jblock.flash = True        # the Pallas kernel, in interpret mode here
    return (jblock, {k: jnp.asarray(v) for k, v in p.items()},
            TransformerBlock(n_model=d, n_heads=heads, causal=causal),
            {k: torch.from_numpy(v) for k, v in p.items()})


@pytest.mark.parametrize("causal", [True, False])
def test_block_matches_jax_flash_block(causal):
    jblock, jp, block, tp = _block_pair(WIDTH, HEADS, causal, seed=11)
    x = np.random.default_rng(12).normal(size=(3, 20, WIDTH)).astype(
        np.float32)
    want, _ = jblock.apply(jp, {}, jnp.asarray(x))
    before = attention.launches
    got, _ = block.apply(tp, {}, torch.from_numpy(x))
    assert attention.launches == before
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=ATOL)


def test_block_masked_path_matches_jax_masked_path():
    jblock, jp, block, tp = _block_pair(WIDTH, HEADS, True, seed=13)
    x = np.random.default_rng(14).normal(size=(3, 9, WIDTH)).astype(
        np.float32)
    mask = np.ones((3, 9), np.float32)
    mask[0, 5:] = 0.0
    mask[2, 2:] = 0.0
    want, _ = jblock.apply(jp, {}, jnp.asarray(x), mask=jnp.asarray(mask))
    got, _ = block.apply(tp, {}, torch.from_numpy(x),
                         mask=torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=ATOL)


def test_block_init_params_keys_and_shapes_match_jax():
    it = InputType.recurrent(WIDTH, SEQ)
    p = TransformerBlock(n_heads=HEADS).init_params(
        torch.Generator().manual_seed(0), it, torch.device("cpu"))
    jp = JaxBlock(n_heads=HEADS).init_params(jax.random.PRNGKey(0),
                                             JaxInputType.recurrent(WIDTH, SEQ))
    assert {k: tuple(v.shape) for k, v in p.items()} == \
        {k: tuple(v.shape) for k, v in jp.items()}
    ptrs = {p[k].data_ptr() for k in ("ln1_g", "ln1_b", "ln2_g", "ln2_b")}
    assert len(ptrs) == 4                      # four distinct tensors
    e = EmbeddingSequenceLayer(n_in=VOCAB, n_out=WIDTH).init_params(
        torch.Generator().manual_seed(0), InputType.recurrent(1, SEQ),
        torch.device("cpu"))
    assert e["W"].shape == (VOCAB, WIDTH) and e["P"].shape == (SEQ, WIDTH)
    with pytest.raises(ValueError, match="not divisible"):
        TransformerBlock(n_heads=5).init_params(
            torch.Generator(), it, torch.device("cpu"))


# ---- the LM ---------------------------------------------------------------

def test_lm_json_from_jax_reemits_equal():
    jax_json = _jax_lm().conf.to_json()
    port = MultiLayerConfiguration.from_json(jax_json)
    assert json.loads(port.to_json()) == json.loads(jax_json)
    assert port.layers[1].activation == "gelu"


def test_lm_port_builder_writes_the_jax_json():
    want = _lm_conf(JaxNNC, JaxEmbedding, JaxBlock, JaxRnnOutput,
                    JaxInputType, JaxAdam).to_json()
    assert json.loads(_port_lm_conf().to_json()) == json.loads(want)


@pytest.mark.parametrize("rows", [1, 3])
def test_jax_zip_output_matches(jax_zip, rows):
    jnet = JaxModelSerializer.restore(jax_zip)
    net = ModelSerializer.restore(jax_zip, device="cpu")
    x = _ids(rows, seed=rows)
    want = np.asarray(jnet.output(x))
    got = net.output(x).numpy()
    assert got.shape == want.shape == (rows, SEQ, VOCAB)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_lm_masked_output_matches_jax(jax_zip):
    jnet = JaxModelSerializer.restore(jax_zip)
    net = ModelSerializer.restore(jax_zip, device="cpu")
    x = _ids(3, seed=9)
    mask = np.ones((3, SEQ), np.float32)
    mask[1, 10:] = 0.0
    want = np.asarray(jnet.output(x, features_mask=mask))
    got = net.output(x, features_mask=mask).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_port_zip_restores_in_jax(tmp_path):
    net = MultiLayerNetwork(_port_lm_conf(), device="cpu").init(
        generator=torch.Generator().manual_seed(5))
    path = str(tmp_path / "port_lm.zip")
    ModelSerializer.write_model(net, path)
    jnet = JaxModelSerializer.restore(path)
    x = _ids(3, seed=2)
    np.testing.assert_allclose(net.output(x).numpy(),
                               np.asarray(jnet.output(x)), rtol=0, atol=ATOL)
    for i, p in enumerate(net.params):
        assert set(p) == set(jnet.params[i])
        for k, v in p.items():
            np.testing.assert_array_equal(np.asarray(jnet.params[i][k]),
                                          v.numpy())


def test_from_jax_params_gives_the_same_outputs():
    jnet = _jax_lm(seed=4)
    params = [{k: np.asarray(v) for k, v in p.items()} for p in jnet.params]
    net = from_jax_params(
        MultiLayerNetwork(_port_lm_conf(), device="cpu").init(), params)
    x = _ids(2, seed=3)
    np.testing.assert_allclose(net.output(x).numpy(),
                               np.asarray(jnet.output(x)), rtol=0, atol=ATOL)


def test_cpu_lm_launches_no_kernel(jax_zip):
    net = ModelSerializer.restore(jax_zip, device="cpu")
    attention.reset_launches()
    out = net.output(_ids(2))
    assert attention.launches == 0
    np.testing.assert_allclose(out.sum(-1).numpy(), 1.0, atol=1e-5)


# ---- served over HTTP -----------------------------------------------------

def _post(url, body):
    req = urllib.request.Request(url, json.dumps(body).encode(),
                                 {"Content-Type": "application/json"},
                                 method="POST")
    with urllib.request.urlopen(req, timeout=60) as resp:
        return resp.status, json.loads(resp.read())


@pytest.fixture(scope="module")
def jax_registry(jax_zip):
    reg = JaxModelRegistry(buckets=(1, 8))
    reg.register("lm", jax_zip)
    return reg


@pytest.mark.parametrize("rows,batched", [(1, True), (5, True), (8, True),
                                          (5, False)])
def test_http_predict_matches_jax_registry(jax_zip, jax_registry, rows,
                                           batched):
    srv = InferenceServer(registry=ModelRegistry(buckets=(1, 8),
                                                 device="cpu"),
                          port=0).start()
    try:
        v = srv.registry.register("lm", jax_zip)
        assert v.example_shape == (SEQ, 1)
        x = _ids(rows, seed=20 + rows)
        want, _ = jax_registry.predict("lm", x)
        code, r = _post(f"http://{srv.host}:{srv.port}/v1/models/lm/predict",
                        {"features": x.tolist(), "batched": batched})
    finally:
        srv.stop()
    assert code == 200 and r["version"] == 1 and r["batched"] == batched
    got = np.asarray(r["output"], np.float32)
    assert got.shape == (rows, SEQ, VOCAB)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    assert not [t for t in threading.enumerate()
                if t.name.startswith("dl4j-torch-serving")]
