"""PyTorch port, REAL multi-process data-parallel training on the CPU: the
twin of `tests/test_multiprocess_distributed.py::
test_two_process_training_matches_single_process` (marked slow, as its
JAX twin is). Two OS processes run the parallel CLI
(`python -m deeplearning4j_tpu_torch.parallel --device cpu`), meet through
`torch.distributed` (gloo) on a localhost rendezvous, and train the same
zip on the same CSV; rank 0 writes the model. Its parameters equal the
one-process CLI run's at 1e-5 (float32 sums in another order). The
elastic drills of the JAX file have their twins in
`test_torch_elastic.py`.
"""
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

import deeplearning4j_tpu_torch as pt
from torch_threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _cli(zip_path, csv, out, n=1, pid=0, port=None):
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    cmd = [sys.executable, "-m", "deeplearning4j_tpu_torch.parallel",
           "--model", zip_path, "--data", csv, "--label-index", "-1",
           "--num-classes", "3", "--batch-size", "32", "--epochs", "2",
           "--device", "cpu", "--save-to", out]
    if port is not None:
        cmd += ["--coordinator", f"127.0.0.1:{port}", "--num-processes",
                str(n), "--process-id", str(pid)]
    return subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


@pytest.mark.slow
def test_two_process_training_matches_single_process(tmp_path):
    conf = (pt.NeuralNetConfiguration.builder().seed(5)
            .updater(pt.Adam(1e-2)).list()
            .layer(pt.DenseLayer(n_out=16, activation="tanh"))
            .layer(pt.OutputLayer(n_out=3, loss="mcxent"))
            .set_input_type(pt.InputType.feed_forward(6)).build())
    zpath = str(tmp_path / "m.zip")
    pt.ModelSerializer.write_model(
        pt.MultiLayerNetwork(conf, device="cpu").init(), zpath)
    r = np.random.default_rng(0)
    x = r.normal(size=(128, 6))
    y = r.integers(0, 3, 128)
    csv = str(tmp_path / "d.csv")
    np.savetxt(csv, np.concatenate([x, y[:, None]], axis=1), delimiter=",")
    single = _cli(zpath, csv, str(tmp_path / "single.zip"))
    assert single.wait(timeout=300) == 0, single.stdout.read()
    port = _free_port()
    procs = [_cli(zpath, csv, str(tmp_path / "two.zip"), 2, pid, port)
             for pid in (0, 1)]
    for p in procs:
        assert p.wait(timeout=300) == 0, p.stdout.read()
    a = pt.ModelSerializer.restore(str(tmp_path / "single.zip"),
                                   device="cpu")
    b = pt.ModelSerializer.restore(str(tmp_path / "two.zip"), device="cpu")
    assert a.iteration_count == b.iteration_count == 8
    np.testing.assert_allclose(b.params_flat(), a.params_flat(), rtol=1e-5,
                               atol=1e-6)
