"""UI server CLI — `python -m deeplearning4j_tpu_torch.ui --port 9000
[--storage stats.jsonl]`.

Reference analog: `PlayUIServer.main` with its JCommander `--uiPort` flag
(`deeplearning4j-play/.../ui/play/PlayUIServer.java:53`, SURVEY.md §2.10).
"""
import argparse
import time


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="deeplearning4j_tpu_torch.ui",
        description="Training-stats dashboard server")
    ap.add_argument("--port", type=int, default=9000,
                    help="HTTP port (reference --uiPort)")
    ap.add_argument("--storage", default=None,
                    help="FileStatsStorage path to attach (watches for "
                         "updates); omit for an empty in-memory storage")
    args = ap.parse_args(argv)

    from .server import UIServer
    from .storage import FileStatsStorage, InMemoryStatsStorage

    storage = (FileStatsStorage(args.storage) if args.storage
               else InMemoryStatsStorage())
    srv = UIServer(port=args.port).attach(storage).start()
    print(f"UI server listening on http://127.0.0.1:{srv.port}/train")
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        srv.stop()


if __name__ == "__main__":
    main()
