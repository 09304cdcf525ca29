"""Cluster provisioning + object-storage access (deeplearning4j-aws analog):
the port of `deeplearning4j_tpu/provision/` (stdlib only).

Reference (SURVEY.md §2.4): `aws/ec2/Ec2BoxCreator.java:37` (boxes),
`ec2/provision/ClusterSetup.java:38` (cluster bring-up + host provisioning),
`s3/reader/S3Downloader.java` / `s3/uploader/S3Uploader.java` (data plane).

The command builders give the JAX package's command lines string for
string (a pod slice through gcloud `tpu-vm`; uploads through `gsutil` /
`aws`), and run them only when asked and the CLI exists.
`StorageDownloader` is a cache lookup: `fetch` finds the object under the
JAX package's cache name (`<sha256(url)[:12]>-<basename>`) and raises
JAX's `IOError` when it is not there. It never opens a connection.
"""
from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

__all__ = ["TpuPodSpec", "TpuClusterSetup", "HostProvisioner",
           "StorageDownloader", "StorageUploader", "object_name"]


@dataclass
class TpuPodSpec:
    """The box-creator config (`Ec2BoxCreator` analog, TPU terms)."""

    name: str
    zone: str = "us-central2-b"
    accelerator_type: str = "v5litepod-8"
    runtime_version: str = "tpu-ubuntu2204-base"
    project: Optional[str] = None
    preemptible: bool = False
    network: Optional[str] = None
    tags: Dict[str, str] = field(default_factory=dict)


class TpuClusterSetup:
    """Builds/executes pod-slice lifecycle commands
    (`ClusterSetup.java:38` analog)."""

    def __init__(self, spec: TpuPodSpec):
        self.spec = spec

    def _base(self) -> List[str]:
        cmd = ["gcloud", "compute", "tpus", "tpu-vm"]
        return cmd

    def create_command(self) -> List[str]:
        s = self.spec
        cmd = self._base() + ["create", s.name, f"--zone={s.zone}",
                              f"--accelerator-type={s.accelerator_type}",
                              f"--version={s.runtime_version}"]
        if s.project:
            cmd.append(f"--project={s.project}")
        if s.preemptible:
            cmd.append("--preemptible")
        if s.network:
            cmd.append(f"--network={s.network}")
        if s.tags:
            kv = ",".join(f"{k}={v}" for k, v in sorted(s.tags.items()))
            cmd.append(f"--labels={kv}")
        return cmd

    def delete_command(self) -> List[str]:
        s = self.spec
        cmd = self._base() + ["delete", s.name, f"--zone={s.zone}",
                              "--quiet"]
        if s.project:
            cmd.append(f"--project={s.project}")
        return cmd

    def ssh_command(self, remote_cmd: str, worker: str = "all") -> List[str]:
        s = self.spec
        cmd = self._base() + ["ssh", s.name, f"--zone={s.zone}",
                              f"--worker={worker}",
                              f"--command={remote_cmd}"]
        if s.project:
            cmd.append(f"--project={s.project}")
        return cmd

    @staticmethod
    def available() -> bool:
        return shutil.which("gcloud") is not None

    def _run(self, cmd: List[str], dry_run: bool) -> Optional[str]:
        if dry_run:
            return None
        if not self.available():
            raise RuntimeError("gcloud CLI not found; use the *_command() "
                               "methods and run them where gcloud exists")
        out = subprocess.run(cmd, capture_output=True, text=True)
        if out.returncode != 0:
            raise RuntimeError(f"{' '.join(cmd[:6])}... failed:\n"
                               f"{out.stderr[-2000:]}")
        return out.stdout

    def create(self, dry_run: bool = True) -> Optional[str]:
        return self._run(self.create_command(), dry_run)

    def delete(self, dry_run: bool = True) -> Optional[str]:
        return self._run(self.delete_command(), dry_run)

    def run_on_workers(self, remote_cmd: str, worker: str = "all",
                       dry_run: bool = True) -> Optional[str]:
        return self._run(self.ssh_command(remote_cmd, worker), dry_run)


class HostProvisioner:
    """Per-host bootstrap (`HostProvisioner.java` analog): emits the setup
    script run on every worker of a fresh slice."""

    def __init__(self, pip_packages: Sequence[str] = (),
                 env: Optional[Dict[str, str]] = None,
                 extra_commands: Sequence[str] = ()):
        self.pip_packages = list(pip_packages)
        self.env = dict(env or {})
        self.extra_commands = list(extra_commands)

    def script(self) -> str:
        import shlex

        lines = ["set -e"]
        for k, v in sorted(self.env.items()):
            lines.append("echo " + shlex.quote(f"export {k}={shlex.quote(v)}")
                         + " >> ~/.bashrc")
        if self.pip_packages:
            lines.append("pip install --upgrade "
                         + " ".join(self.pip_packages))
        lines.extend(self.extra_commands)
        return "\n".join(lines)

    def provision(self, cluster: TpuClusterSetup,
                  dry_run: bool = True) -> Optional[str]:
        return cluster.run_on_workers(self.script(), dry_run=dry_run)


def _to_https(url: str) -> str:
    if url.startswith("gs://"):
        return "https://storage.googleapis.com/" + url[len("gs://"):]
    if url.startswith("s3://"):
        bucket, _, key = url[len("s3://"):].partition("/")
        return f"https://{bucket}.s3.amazonaws.com/{key}"
    return url


def object_name(url: str) -> str:
    """The object's basename (`object` for a URL that ends in a slash)."""
    return url.rstrip("/").rsplit("/", 1)[-1] or "object"


class StorageDownloader:
    """Cached objects (`S3Downloader` role) under the JAX package's cache
    names. Nothing is downloaded: an object must already be in the cache."""

    def __init__(self, cache_dir: Optional[str] = None):
        from ..datasets.fetchers import data_dir
        self.cache_dir = cache_dir or data_dir("storage")

    @staticmethod
    def cache_name(url: str) -> str:
        """`<sha256(url)[:12]>-<basename>`: the key includes the full URL,
        so two objects that share a basename do not alias each other."""
        digest = hashlib.sha256(url.encode()).hexdigest()[:12]
        return f"{digest}-{object_name(url)}"

    def fetch(self, url: str, timeout: int = 60) -> str:
        """The cached copy of `url`; `timeout` is accepted for JAX's
        signature (no connection is opened)."""
        dest = os.path.join(self.cache_dir, self.cache_name(url))
        if os.path.exists(dest):
            return dest
        raise IOError(f"download failed: {url} is not in the cache as "
                      f"{dest} (nothing is downloaded)")


class StorageUploader:
    """Uploads via the host's cloud CLI when present (`S3Uploader` role)."""

    def command(self, local_path: str, url: str) -> List[str]:
        if url.startswith("gs://"):
            return ["gsutil", "cp", local_path, url]
        if url.startswith("s3://"):
            return ["aws", "s3", "cp", local_path, url]
        raise ValueError(f"unsupported destination {url!r}")

    def upload(self, local_path: str, url: str,
               dry_run: bool = True) -> Optional[str]:
        cmd = self.command(local_path, url)
        if dry_run:
            return None
        if shutil.which(cmd[0]) is None:
            raise RuntimeError(f"{cmd[0]} CLI not found")
        out = subprocess.run(cmd, capture_output=True, text=True)
        if out.returncode != 0:
            raise RuntimeError(out.stderr[-2000:])
        return out.stdout
