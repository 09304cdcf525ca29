"""Inverted document index (reference `text/invertedindex/` — the
Lucene-backed index DL4J uses for document retrieval and batch sampling
behind BoW/TF-IDF).

Self-contained replacement for the vendored Lucene surface: term ->
postings with positions, TF-IDF cosine ranked search, phrase queries, and
the `batch_iter`-style document sampling the reference exposes to its
vectorizers. Pure host-side (retrieval is not an accelerator workload).
"""
from __future__ import annotations

import math
import threading
from collections import Counter
from typing import Dict, List, Optional, Sequence, Tuple

from .tokenization import DefaultTokenizerFactory, TokenizerFactory

__all__ = ["InvertedIndex"]


class InvertedIndex:
    """In-memory inverted index over tokenized documents."""

    def __init__(self, tokenizer_factory: Optional[TokenizerFactory] = None):
        self._tf = tokenizer_factory or DefaultTokenizerFactory()
        # term -> {doc_id -> [positions]}
        self._postings: Dict[str, Dict[int, List[int]]] = {}
        self._docs: List[List[str]] = []
        self._labels: List[Optional[str]] = []
        self._norms: Dict[int, float] = {}   # doc norm cache; idf-dependent,
        self._lock = threading.RLock()       # so cleared on every add

    # ------------------------------------------------------------------
    def add_document(self, text_or_tokens, label: Optional[str] = None
                     ) -> int:
        """Index a document; returns its doc id."""
        if isinstance(text_or_tokens, str):
            tokens = self._tf.create(text_or_tokens).get_tokens()
        else:
            tokens = list(text_or_tokens)
        with self._lock:
            doc_id = len(self._docs)
            self._docs.append(tokens)
            self._labels.append(label)
            for pos, term in enumerate(tokens):
                self._postings.setdefault(term, {}) \
                    .setdefault(doc_id, []).append(pos)
            # every doc's TF-IDF norm depends on corpus-wide idf
            self._norms.clear()
        return doc_id

    def num_documents(self) -> int:
        return len(self._docs)

    def document(self, doc_id: int) -> List[str]:
        return list(self._docs[doc_id])

    def label(self, doc_id: int) -> Optional[str]:
        return self._labels[doc_id]

    # ------------------------------------------------------------------
    def document_frequency(self, term: str) -> int:
        with self._lock:
            return len(self._postings.get(term, {}))

    def term_frequency(self, term: str, doc_id: int) -> int:
        return len(self._postings.get(term, {}).get(doc_id, ()))

    def documents_containing(self, term: str) -> List[int]:
        with self._lock:
            return sorted(self._postings.get(term, {}))

    def _idf(self, term: str) -> float:
        df = self.document_frequency(term)
        if df == 0:
            return 0.0
        return math.log((1.0 + len(self._docs)) / (1.0 + df)) + 1.0

    # ------------------------------------------------------------------
    def _doc_norm(self, doc_id: int) -> float:
        n = self._norms.get(doc_id)
        if n is None:
            n = math.sqrt(sum(
                (self.term_frequency(t, doc_id) * self._idf(t)) ** 2
                for t in set(self._docs[doc_id]))) or 1.0
            self._norms[doc_id] = n
        return n

    def search(self, query, top_n: int = 10) -> List[Tuple[int, float]]:
        """TF-IDF cosine-ranked search. Returns [(doc_id, score)] sorted by
        descending score. Document norms are cached (invalidated on add —
        idf shifts with the corpus)."""
        if isinstance(query, str):
            q_tokens = self._tf.create(query).get_tokens()
        else:
            q_tokens = list(query)
        with self._lock:
            q_tf = Counter(q_tokens)
            q_weights = {t: tf * self._idf(t) for t, tf in q_tf.items()}
            q_norm = math.sqrt(sum(w * w
                                   for w in q_weights.values())) or 1.0
            scores: Dict[int, float] = {}
            for term, qw in q_weights.items():
                idf = self._idf(term)
                for doc_id, positions in self._postings.get(term,
                                                            {}).items():
                    scores[doc_id] = scores.get(doc_id, 0.0) \
                        + qw * len(positions) * idf
            out = [(doc_id, s / (q_norm * self._doc_norm(doc_id)))
                   for doc_id, s in scores.items()]
        out.sort(key=lambda p: (-p[1], p[0]))
        return out[:top_n]

    def phrase_search(self, phrase, top_n: int = 10) -> List[int]:
        """Documents containing the exact token sequence (positional
        intersection — the Lucene phrase-query capability)."""
        if isinstance(phrase, str):
            terms = self._tf.create(phrase).get_tokens()
        else:
            terms = list(phrase)
        if not terms:
            return []
        with self._lock:
            return self._phrase_locked(terms, top_n)

    def _phrase_locked(self, terms, top_n):
        candidates = set(self._postings.get(terms[0], {}))
        for t in terms[1:]:
            candidates &= set(self._postings.get(t, {}))
        hits = []
        for doc_id in sorted(candidates):
            starts = set(self._postings[terms[0]][doc_id])
            for off, t in enumerate(terms[1:], start=1):
                starts &= {p - off for p in self._postings[t][doc_id]}
                if not starts:
                    break
            if starts:
                hits.append(doc_id)
            if len(hits) >= top_n:
                break
        return hits

    # ------------------------------------------------------------------
    def batch_iter(self, batch_size: int):
        """Yield documents in fixed-size batches (the reference index's
        `batchIter` feeding vectorizer minibatches)."""
        for i in range(0, len(self._docs), batch_size):
            yield [list(d) for d in self._docs[i:i + batch_size]]

    def eachdoc(self):
        for i, d in enumerate(self._docs):
            yield i, list(d)
