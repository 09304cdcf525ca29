"""PyTorch port, provisioning (`deeplearning4j_tpu_torch/provision/`) on the
CPU, held against the JAX package.

The twins of `tests/test_aux_surface.py`'s four provisioning cases and of
`tests/test_cli.py::test_provision_cli_prints_commands`; the command
builders give JAX's command lines string for string; `StorageDownloader`
is a cache lookup under JAX's cache name that opens no connection, and
`modelimport.trainedmodels.cached_file` takes its name from it.
"""
import hashlib
import socket
import subprocess
import sys

import pytest

import deeplearning4j_tpu.provision as jprov
from deeplearning4j_tpu_torch.provision import (HostProvisioner,
                                                StorageDownloader,
                                                StorageUploader,
                                                TpuClusterSetup, TpuPodSpec,
                                                _to_https)
from torch_threads import one_torch_thread  # noqa: F401


# -- the twins of tests/test_aux_surface.py and tests/test_cli.py --------------

def test_tpu_cluster_setup_commands():
    spec = TpuPodSpec(name="trainer", zone="us-east5-a",
                      accelerator_type="v5litepod-16", project="proj",
                      preemptible=True, tags={"team": "ml"})
    setup = TpuClusterSetup(spec)
    create = setup.create_command()
    assert create[:5] == ["gcloud", "compute", "tpus", "tpu-vm", "create"]
    assert "trainer" in create and "--zone=us-east5-a" in create
    assert "--accelerator-type=v5litepod-16" in create
    assert "--project=proj" in create and "--preemptible" in create
    assert "--labels=team=ml" in create
    delete = setup.delete_command()
    assert "delete" in delete and "--quiet" in delete
    ssh = setup.ssh_command("hostname", worker="0")
    assert "--worker=0" in ssh and "--command=hostname" in ssh
    # dry-run never shells out
    assert setup.create(dry_run=True) is None


def test_host_provisioner_script():
    prov = HostProvisioner(pip_packages=["jax[tpu]"],
                           env={"JAX_PLATFORMS": "tpu"},
                           extra_commands=["echo done"])
    script = prov.script()
    assert "pip install --upgrade jax[tpu]" in script
    assert "JAX_PLATFORMS=tpu" in script
    assert script.endswith("echo done")


def test_storage_uploader_commands():
    up = StorageUploader()
    assert up.command("/tmp/f", "gs://b/k")[:2] == ["gsutil", "cp"]
    assert up.command("/tmp/f", "s3://b/k")[:3] == ["aws", "s3", "cp"]
    with pytest.raises(ValueError):
        up.command("/tmp/f", "ftp://x")
    assert up.upload("/tmp/f", "gs://b/k", dry_run=True) is None


def test_storage_url_rewrite():
    assert _to_https("gs://bucket/a/b.txt") == \
        "https://storage.googleapis.com/bucket/a/b.txt"
    assert _to_https("s3://bucket/k.bin") == \
        "https://bucket.s3.amazonaws.com/k.bin"
    assert _to_https("https://x/y") == "https://x/y"


def test_provision_cli_prints_commands():
    out = subprocess.run(
        [sys.executable, "-m", "deeplearning4j_tpu_torch.provision",
         "create", "--name", "t1", "--zone", "us-east5-a",
         "--accelerator", "v5litepod-16"],
        capture_output=True, text=True, timeout=60)
    assert out.returncode == 0, out.stderr
    assert "gcloud compute tpus tpu-vm create t1" in out.stdout
    assert "--accelerator-type=v5litepod-16" in out.stdout


# -- parity with the JAX package ------------------------------------------

@pytest.mark.parametrize("spec", [
    dict(name="a"),
    dict(name="trainer", zone="us-east5-a", accelerator_type="v5litepod-16",
         runtime_version="v2-alpha", project="proj", preemptible=True,
         network="net1", tags={"team": "ml", "env": "dev"})])
def test_commands_equal_jax(spec):
    got = TpuClusterSetup(TpuPodSpec(**spec))
    want = jprov.TpuClusterSetup(jprov.TpuPodSpec(**spec))
    assert got.create_command() == want.create_command()
    assert got.delete_command() == want.delete_command()
    assert got.ssh_command("ls -l 'x y'", worker="3") == \
        want.ssh_command("ls -l 'x y'", worker="3")
    kw = dict(pip_packages=["numpy", "a b"], env={"K": "v w", "A": "1"},
              extra_commands=["echo $HOME"])
    assert HostProvisioner(**kw).script() == \
        jprov.HostProvisioner(**kw).script()
    for url in ("gs://b/k/x.bin", "s3://b/k"):
        assert StorageUploader().command("/f", url) == \
            jprov.StorageUploader().command("/f", url)
    for url in ("gs://b/k/x.bin", "s3://b/k", "https://h/p", "s3://b"):
        assert _to_https(url) == jprov._to_https(url)


def test_provision_cli_output_equals_jax():
    args = ["ssh", "--name", "t1", "--zone", "us-east5-a", "--command",
            "echo 'hi there'", "--project", "p"]
    outs = [subprocess.run([sys.executable, "-m", mod] + args,
                           capture_output=True, text=True, timeout=60)
            for mod in ("deeplearning4j_tpu_torch.provision",
                        "deeplearning4j_tpu.provision")]
    assert outs[0].returncode == outs[1].returncode == 0, outs[0].stderr
    assert outs[0].stdout == outs[1].stdout


def test_storage_downloader_is_a_cache_lookup(tmp_path, monkeypatch):
    """A cached object is found under JAX's name; a missing one raises
    JAX's IOError without a connection."""
    def no_network(*a, **k):
        raise AssertionError("a connection was opened")
    monkeypatch.setattr(socket, "create_connection", no_network)
    monkeypatch.setattr(socket.socket, "connect", no_network)
    url = "gs://bucket/models/weights.h5"
    dl = StorageDownloader(str(tmp_path))
    with pytest.raises(IOError, match="download failed"):
        dl.fetch(url)
    name = StorageDownloader.cache_name(url)
    assert name == hashlib.sha256(url.encode()).hexdigest()[:12] + \
        "-weights.h5"
    (tmp_path / name).write_bytes(b"w")
    assert dl.fetch(url) == str(tmp_path / name)

    from deeplearning4j_tpu_torch.modelimport.trainedmodels import \
        cached_file
    assert cached_file(url, str(tmp_path)) == str(tmp_path / name)
