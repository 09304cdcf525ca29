"""Observability stack (L9): the port of `deeplearning4j_tpu/ui/`.

Capability parity with the reference's stats pipeline
(`ui/stats/BaseStatsListener.java:43` → SBE-encoded `StatsReport` →
`StatsStorage` (`deeplearning4j-core/.../api/storage/StatsStorage.java`) →
Play web UI (`PlayUIServer.java:53`, `module/train/TrainModule.java:53`)).

Shape: the listener snapshots score/param/update statistics from the
parameter tree between training steps (the score and one copy of every
parameter to the host per report), reports are plain dicts serialized as
JSON-lines (replacing the SBE binary codec), storage is pluggable
(in-memory / file / sqlite), and the dashboard is a dependency-free stdlib
http.server rendering overview/model/system pages. Only the listeners touch
torch; the storages, the server and the components are the JAX package's
code.
"""
from .stats import StatsListener, StatsReport
from .storage import (FileStatsStorage, InMemoryStatsStorage,
                      SqliteStatsStorage, StatsStorage,
                      StatsStorageEvent, StatsStorageListener)
from .server import UIServer
from .legacy_listeners import (WebReporter, RemoteFlowIterationListener,
                               RemoteHistogramIterationListener)

__all__ = [
    "WebReporter", "RemoteFlowIterationListener",
    "RemoteHistogramIterationListener", "SqliteStatsStorage",
    "StatsListener", "StatsReport", "StatsStorage", "InMemoryStatsStorage",
    "FileStatsStorage", "StatsStorageEvent", "StatsStorageListener",
    "UIServer",
]
