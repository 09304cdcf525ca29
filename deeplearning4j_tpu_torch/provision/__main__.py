"""Provisioning CLI — `python -m deeplearning4j_tpu_torch.provision create
--name trainer --zone us-east5-a --accelerator v5litepod-16 [--apply]`.

Reference analog: `ClusterSetup.java:38` (args4j main, SURVEY.md §2.10).
Prints the gcloud command by default; --apply executes it.
"""
import argparse
import shlex


def main(argv=None):
    ap = argparse.ArgumentParser(prog="deeplearning4j_tpu_torch.provision")
    ap.add_argument("action", choices=["create", "delete", "ssh"])
    ap.add_argument("--name", required=True)
    ap.add_argument("--zone", default="us-central2-b")
    ap.add_argument("--accelerator", default="v5litepod-8")
    ap.add_argument("--version", default="tpu-ubuntu2204-base")
    ap.add_argument("--project", default=None)
    ap.add_argument("--preemptible", action="store_true")
    ap.add_argument("--command", default="hostname",
                    help="remote command for the ssh action")
    ap.add_argument("--apply", action="store_true",
                    help="execute instead of printing")
    args = ap.parse_args(argv)

    from . import TpuClusterSetup, TpuPodSpec

    setup = TpuClusterSetup(TpuPodSpec(
        name=args.name, zone=args.zone, accelerator_type=args.accelerator,
        runtime_version=args.version, project=args.project,
        preemptible=args.preemptible))
    if args.apply:
        run = {"create": setup.create,
               "delete": setup.delete,
               "ssh": lambda **kw: setup.run_on_workers(args.command,
                                                        **kw)}[args.action]
        print(run(dry_run=False) or "")
    else:
        cmd = {"create": setup.create_command,
               "delete": setup.delete_command,
               "ssh": lambda: setup.ssh_command(args.command)}[args.action]()
        print(" ".join(shlex.quote(c) for c in cmd))


if __name__ == "__main__":
    main()
