"""Sentence / document iterators.

Parity with `text/sentenceiterator/` (BasicSentenceIterator,
CollectionSentenceIterator, LineSentenceIterator, FileSentenceIterator,
label-aware variants) and `text/documentiterator/` (LabelAwareIterator,
LabelsSource, LabelledDocument).
"""
from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Iterable, List, Optional, Sequence

__all__ = [
    "SentenceIterator", "BasicSentenceIterator", "CollectionSentenceIterator",
    "LineSentenceIterator", "FileSentenceIterator",
    "LabelledDocument", "LabelsSource", "LabelAwareIterator",
    "BasicLabelAwareIterator", "CollectionLabeledSentenceIterator",
]


class SentenceIterator:
    def __init__(self):
        self._preprocessor = None

    def set_pre_processor(self, p):
        self._preprocessor = p

    def _prep(self, s: str) -> str:
        return self._preprocessor(s) if self._preprocessor else s

    def next_sentence(self) -> str:
        raise NotImplementedError

    def has_next(self) -> bool:
        raise NotImplementedError

    def reset(self):
        raise NotImplementedError

    def __iter__(self):
        self.reset()
        while self.has_next():
            yield self.next_sentence()


class CollectionSentenceIterator(SentenceIterator):
    def __init__(self, sentences: Sequence[str]):
        super().__init__()
        self._sentences = list(sentences)
        self._pos = 0

    def next_sentence(self) -> str:
        s = self._sentences[self._pos]
        self._pos += 1
        return self._prep(s)

    def has_next(self) -> bool:
        return self._pos < len(self._sentences)

    def reset(self):
        self._pos = 0


BasicSentenceIterator = CollectionSentenceIterator


class LineSentenceIterator(SentenceIterator):
    """One sentence per line from a file."""

    def __init__(self, path: str):
        super().__init__()
        self.path = path
        self._fh = None
        self._next = None
        self.reset()

    def reset(self):
        if self._fh:
            self._fh.close()
        self._fh = open(self.path, "r", encoding="utf-8", errors="replace")
        self._advance()

    def _advance(self):
        line = self._fh.readline()
        while line is not None and line != "" and not line.strip():
            line = self._fh.readline()
        self._next = line.strip() if line else None

    def has_next(self) -> bool:
        return bool(self._next)

    def next_sentence(self) -> str:
        s = self._next
        self._advance()
        return self._prep(s)


class FileSentenceIterator(SentenceIterator):
    """All lines of all files under a directory."""

    def __init__(self, root: str):
        super().__init__()
        self.root = root
        self.reset()

    def reset(self):
        self._files = []
        if os.path.isdir(self.root):
            for dirpath, _, names in sorted(os.walk(self.root)):
                for n in sorted(names):
                    self._files.append(os.path.join(dirpath, n))
        else:
            self._files = [self.root]
        self._file_idx = 0
        self._lines: List[str] = []
        self._line_idx = 0
        self._load_next_file()

    def _load_next_file(self):
        self._lines = []
        self._line_idx = 0
        while self._file_idx < len(self._files) and not self._lines:
            with open(self._files[self._file_idx], encoding="utf-8",
                      errors="replace") as f:
                self._lines = [l.strip() for l in f if l.strip()]
            self._file_idx += 1

    def has_next(self) -> bool:
        return self._line_idx < len(self._lines)

    def next_sentence(self) -> str:
        s = self._lines[self._line_idx]
        self._line_idx += 1
        if self._line_idx >= len(self._lines):
            self._load_next_file()
        return self._prep(s)


# --------------------------- label-aware -----------------------------------

@dataclass
class LabelledDocument:
    content: str = ""
    labels: List[str] = field(default_factory=list)


class LabelsSource:
    """Tracks/generates document labels (reference LabelsSource)."""

    def __init__(self, template: str = "DOC_%d"):
        self.template = template
        self._labels: List[str] = []
        self._counter = 0

    def next_label(self) -> str:
        label = self.template % self._counter
        self._counter += 1
        self._labels.append(label)
        return label

    def store_label(self, label: str):
        if label not in self._labels:
            self._labels.append(label)

    def get_labels(self) -> List[str]:
        return list(self._labels)

    def index_of(self, label: str) -> int:
        return self._labels.index(label)

    def size(self) -> int:
        return len(self._labels)


class LabelAwareIterator:
    def has_next_document(self) -> bool:
        raise NotImplementedError

    def next_document(self) -> LabelledDocument:
        raise NotImplementedError

    def reset(self):
        raise NotImplementedError

    def get_labels_source(self) -> LabelsSource:
        raise NotImplementedError

    def __iter__(self):
        self.reset()
        while self.has_next_document():
            yield self.next_document()


class BasicLabelAwareIterator(LabelAwareIterator):
    """Wraps a SentenceIterator, auto-generating DOC_N labels (reference
    BasicLabelAwareIterator.Builder)."""

    def __init__(self, sentence_iterator: SentenceIterator,
                 template: str = "DOC_%d"):
        self._src = sentence_iterator
        self._labels = LabelsSource(template)
        self._generated: List[str] = []
        self._pos = 0
        self._materialize()

    def _materialize(self):
        self._docs = []
        self._src.reset()
        while self._src.has_next():
            label = self._labels.next_label()
            self._docs.append(LabelledDocument(self._src.next_sentence(),
                                               [label]))

    def has_next_document(self):
        return self._pos < len(self._docs)

    def next_document(self):
        d = self._docs[self._pos]
        self._pos += 1
        return d

    def reset(self):
        self._pos = 0

    def get_labels_source(self):
        return self._labels


class CollectionLabeledSentenceIterator(LabelAwareIterator):
    """(text, label) pairs."""

    def __init__(self, texts: Sequence[str], labels: Sequence[str]):
        self._docs = [LabelledDocument(t, [l]) for t, l in zip(texts, labels)]
        self._labels = LabelsSource()
        for l in labels:
            self._labels.store_label(l)
        self._pos = 0

    def has_next_document(self):
        return self._pos < len(self._docs)

    def next_document(self):
        d = self._docs[self._pos]
        self._pos += 1
        return d

    def reset(self):
        self._pos = 0

    def get_labels_source(self):
        return self._labels
