"""Vocabulary construction + Huffman coding.

Parity with `models/word2vec/wordstore/`:
  * VocabWord (`models/word2vec/VocabWord.java`) — element with frequency,
    index, huffman code/points
  * AbstractCache-style VocabCache (word <-> index <-> frequency)
  * VocabConstructor (`VocabConstructor.java:32`) — min-frequency filtering,
    special-token retention, merged vocab building
  * Huffman (`models/word2vec/Huffman.java`) — binary tree over frequencies
    producing codes/points for hierarchical softmax
"""
from __future__ import annotations

import heapq
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence

import numpy as np

__all__ = ["VocabWord", "VocabCache", "VocabConstructor", "Huffman"]


@dataclass
class VocabWord:
    word: str
    count: float = 1.0
    index: int = -1
    is_label: bool = False
    # hierarchical softmax:
    code: List[int] = field(default_factory=list)    # binary path (0/1)
    points: List[int] = field(default_factory=list)  # inner-node indices


class VocabCache:
    """In-memory vocab (reference `inmemory/AbstractCache.java`)."""

    def __init__(self):
        self._words: Dict[str, VocabWord] = {}
        self._by_index: List[VocabWord] = []
        self.total_word_count = 0.0

    def add_token(self, vw: VocabWord):
        if vw.word in self._words:
            self._words[vw.word].count += vw.count
        else:
            self._words[vw.word] = vw

    def increment_count(self, word: str, by: float = 1.0):
        if word in self._words:
            self._words[word].count += by

    def contains_word(self, word: str) -> bool:
        return word in self._words

    def word_frequency(self, word: str) -> float:
        vw = self._words.get(word)
        return vw.count if vw else 0.0

    def word_for(self, word: str) -> Optional[VocabWord]:
        return self._words.get(word)

    def index_of(self, word: str) -> int:
        vw = self._words.get(word)
        return vw.index if vw else -1

    def word_at_index(self, idx: int) -> Optional[str]:
        if 0 <= idx < len(self._by_index):
            return self._by_index[idx].word
        return None

    def element_at_index(self, idx: int) -> Optional[VocabWord]:
        if 0 <= idx < len(self._by_index):
            return self._by_index[idx]
        return None

    def num_words(self) -> int:
        return len(self._by_index)

    def words(self) -> List[str]:
        return [vw.word for vw in self._by_index]

    def vocab_words(self) -> List[VocabWord]:
        return list(self._by_index)

    def update_indices(self):
        """Assign indices by descending frequency (reference ordering)."""
        ordered = sorted(self._words.values(),
                         key=lambda v: (-v.count, v.word))
        self._by_index = ordered
        for i, vw in enumerate(ordered):
            vw.index = i
        self.total_word_count = float(sum(v.count for v in ordered))

    def counts_array(self) -> np.ndarray:
        return np.array([v.count for v in self._by_index], np.float64)


class VocabConstructor:
    """Builds a VocabCache from token sequences with min-frequency filtering
    (reference `VocabConstructor.buildMergedVocabulary:74`)."""

    def __init__(self, min_word_frequency: int = 1,
                 special_tokens: Sequence[str] = ()):
        self.min_word_frequency = int(min_word_frequency)
        self.special_tokens = set(special_tokens)

    def build_vocab(self, token_sequences: Iterable[Sequence[str]],
                    labels: Iterable[Sequence[str]] = ()) -> VocabCache:
        from collections import Counter

        counts: Dict[str, float] = Counter()
        for seq in token_sequences:
            counts.update(seq)
        cache = VocabCache()
        for w, c in counts.items():
            if c >= self.min_word_frequency or w in self.special_tokens:
                cache.add_token(VocabWord(w, c))
        for label_seq in labels:
            for label in label_seq:
                if not cache.contains_word(label):
                    cache.add_token(VocabWord(label, 1.0, is_label=True))
        cache.update_indices()
        return cache


class Huffman:
    """Huffman tree over word frequencies -> (code, points) per word
    (reference `models/word2vec/Huffman.java`). Max code length 40 as in the
    reference."""

    MAX_CODE_LENGTH = 40

    def __init__(self, vocab: VocabCache):
        self.vocab = vocab

    def build(self):
        words = self.vocab.vocab_words()
        n = len(words)
        if n == 0:
            return
        # heap of (count, uid, node); leaves 0..n-1, inner nodes n..2n-2
        heap = [(w.count, i, i) for i, w in enumerate(words)]
        heapq.heapify(heap)
        parent = {}
        binary = {}
        next_id = n
        while len(heap) > 1:
            c1, _, a = heapq.heappop(heap)
            c2, _, b = heapq.heappop(heap)
            parent[a] = next_id
            parent[b] = next_id
            binary[a] = 0
            binary[b] = 1
            heapq.heappush(heap, (c1 + c2, next_id, next_id))
            next_id += 1
        root = heap[0][2] if heap else None
        for i, w in enumerate(words):
            code, points = [], []
            node = i
            while node != root:
                code.append(binary[node])
                p = parent[node]
                points.append(p - n)  # inner-node index in [0, n-1)
                node = p
            w.code = list(reversed(code))[: self.MAX_CODE_LENGTH]
            w.points = list(reversed(points))[: self.MAX_CODE_LENGTH]

    def codes_arrays(self, max_len: Optional[int] = None):
        """Padded [V, L] codes/points (+mask) for batched HS training — the
        dense layout the batched path consumes instead of per-word lists."""
        words = self.vocab.vocab_words()
        L = max_len or max((len(w.code) for w in words), default=1)
        V = len(words)
        codes = np.zeros((V, L), np.float32)
        points = np.zeros((V, L), np.int32)
        mask = np.zeros((V, L), np.float32)
        for i, w in enumerate(words):
            l = min(len(w.code), L)
            codes[i, :l] = w.code[:l]
            points[i, :l] = w.points[:l]
            mask[i, :l] = 1.0
        return codes, points, mask
