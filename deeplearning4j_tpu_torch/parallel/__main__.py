"""Parallel-training CLI — `python -m deeplearning4j_tpu_torch.parallel
--model model.zip --data train.csv --label-index -1 --num-classes 3`.

Reference analog: `ParallelWrapperMain.java`: load a serialized model,
train it data-parallel, save it back. It runs on the card unless given
`--device cpu`. Launched once, it is a world of one rank (on the card, a
one-rank NCCL group when `--coordinator` is given); under torchrun (or
with `--coordinator`, `--num-processes`, `--process-id`) every rank runs
it and rank 0 writes the model.
"""
import argparse


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="deeplearning4j_tpu_torch.parallel",
        description="Train a serialized model data-parallel over the "
                    "ranks of a torch.distributed group")
    ap.add_argument("--model", required=True, help="model zip "
                    "(ModelSerializer format)")
    ap.add_argument("--data", required=True, help="numeric CSV")
    ap.add_argument("--label-index", type=int, default=-1)
    ap.add_argument("--num-classes", type=int, default=0,
                    help="one-hot classes; 0 = regression")
    ap.add_argument("--batch-size", type=int, default=64,
                    help="global batch size")
    ap.add_argument("--epochs", type=int, default=1)
    ap.add_argument("--averaging-frequency", type=int, default=0,
                    help="0 = per-step sync all-reduce; N = local SGD with "
                         "parameter averaging every N steps")
    ap.add_argument("--device", default=None,
                    help="'cpu' to train on the CPU (default: the GPU)")
    ap.add_argument("--coordinator", default=None,
                    help="host:port of rank 0 (default: the environment's "
                         "JAX_COORDINATOR_ADDRESS / MASTER_ADDR:PORT)")
    ap.add_argument("--num-processes", type=int, default=None)
    ap.add_argument("--process-id", type=int, default=None)
    ap.add_argument("--save-to", default=None,
                    help="output model zip (default: overwrite --model)")
    args = ap.parse_args(argv)

    from ..datasets.records import RecordReaderDataSetIterator
    from ..util.serializer import ModelSerializer
    from . import ParallelTrainer, TrainingMode, initialize, make_mesh
    from .distributed import process_index

    initialize(args.coordinator, args.num_processes, args.process_id,
               device=args.device)
    mesh = make_mesh(device=args.device)
    net = ModelSerializer.restore(args.model, device=mesh.device)
    it = RecordReaderDataSetIterator(
        args.data, batch_size=args.batch_size,
        label_index=args.label_index, num_classes=args.num_classes,
        regression=args.num_classes <= 0)
    trainer = ParallelTrainer(
        net, mesh=mesh,
        mode=(TrainingMode.AVERAGING if args.averaging_frequency
              else TrainingMode.SYNC),
        averaging_frequency=args.averaging_frequency or 1)
    for _ in range(args.epochs):
        it.reset()
        while it.has_next():
            trainer.fit(it.next())
    if process_index() == 0:
        ModelSerializer.write_model(net, args.save_to or args.model)
    print(f"trained {args.epochs} epoch(s) on {mesh.size} rank(s) "
          f"({mesh.device}); final score {float(trainer.score()):.6f}")


if __name__ == "__main__":
    main()
