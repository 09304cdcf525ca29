"""Crash-consistent transition journal for the continual plane (the port's
own copy of `deeplearning4j_tpu/continual/journal.py`: the file format is
the same, so a journal written by either package replays in the other).

An append-only JSONL file: one `\\n`-terminated JSON object per record,
written with a single `write` + flush + fsync. A record is COMMITTED iff
its full line (including the terminating newline) is on disk — the same
commit discipline as the topic log's length-prefixed records and the
checkpoint zips' atomic rename. On replay, a torn final line (crash
mid-append) is silently dropped: the transition it described never
happened, exactly like an uncommitted transaction. A malformed line that
IS newline-terminated cannot be produced by a torn append and therefore
means real corruption — replay raises instead of guessing.

Record kinds written by the ContinualTrainer:

  promoted    {cycle, ckpt, offset, score}  this checkpoint is the
              stable servable and the topic is consumed through
              `offset`. The LAST promoted record IS the recovery state.
  window      {cycle, start, end, batches, skipped, nonfinite}  a fresh
              window was trained into a saved candidate. Once durable,
              the window counts as trained: recovery resumes the
              consumer AFTER `end`, never retraining (and, because the
              record lands before the offset commit, never skipping) it.
  gate        {cycle, passed, cand_score, stable_score}
  canary      {cycle, version, fraction}    candidate is live behind
              canary routing, decision pending.
  rolled_back {cycle, reason}               candidate discarded; the
              previous promoted record keeps being the stable state.

A cycle whose last record is `window`/`gate`/`canary` is OPEN
(undecided): recovery closes it with `rolled_back {crash_recovery}` —
an undecided candidate is never served after a restart.
"""
from __future__ import annotations

import json
import os
import time
from typing import Dict, List

__all__ = ["ContinualJournal", "JournalCorruptError"]


class JournalCorruptError(RuntimeError):
    """A newline-terminated journal line failed to parse — not a torn
    tail (those are dropped) but genuine corruption."""


class ContinualJournal:
    """Append-only JSONL transition log with torn-tail-tolerant replay."""

    def __init__(self, path: str, fsync: bool = True):
        self.path = str(path)
        self.fsync = fsync
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)

    def append(self, kind: str, **fields) -> Dict:
        """Durably append one record; returns it. The record is committed
        the moment this returns — a crash after the return can never lose
        it, a crash before leaves at most a torn (ignored) tail."""
        rec = dict(kind=str(kind), ts=time.time(), **fields)
        line = json.dumps(rec, sort_keys=True)
        if "\n" in line:
            raise ValueError("journal records must be single-line JSON")
        with open(self.path, "a", encoding="utf-8") as f:
            f.write(line + "\n")
            f.flush()
            if self.fsync:
                os.fsync(f.fileno())
        return rec

    def replay(self) -> List[Dict]:
        """All committed records, in append order. A torn final line is
        dropped; a malformed committed line raises JournalCorruptError."""
        try:
            with open(self.path, "rb") as f:
                raw = f.read()
        except FileNotFoundError:
            return []
        out: List[Dict] = []
        body, sep, torn = raw.rpartition(b"\n")
        # `torn` (bytes past the last newline) is an uncommitted tail —
        # dropped by design. Every line BEFORE it was fully written.
        del torn
        if not sep:
            return []
        for i, line in enumerate(body.split(b"\n")):
            if not line.strip():
                continue
            try:
                rec = json.loads(line.decode("utf-8"))
            except (ValueError, UnicodeDecodeError) as e:
                raise JournalCorruptError(
                    f"{self.path}: committed journal line {i + 1} is "
                    f"malformed: {e}") from None
            if not isinstance(rec, dict) or "kind" not in rec:
                raise JournalCorruptError(
                    f"{self.path}: committed journal line {i + 1} is not "
                    "a record object")
            out.append(rec)
        return out
