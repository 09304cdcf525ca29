"""Count-based text vectorizers.

Parity with `bagofwords/vectorizer/`: BagOfWordsVectorizer (term counts) and
TfidfVectorizer (tf-idf weights), fit over a sentence iterator + tokenizer,
producing dense [n_docs, vocab] matrices / per-text transform vectors.
(The reference backs these with a Lucene inverted index; a host-side counting
pass serves the same API without the dependency.)
"""
from __future__ import annotations

import math
from typing import List, Optional, Sequence

import numpy as np

from .sentence_iterator import SentenceIterator
from .tokenization import DefaultTokenizerFactory, TokenizerFactory
from .vocab import VocabCache, VocabConstructor

__all__ = ["BagOfWordsVectorizer", "TfidfVectorizer"]


class BagOfWordsVectorizer:
    def __init__(self, sentence_iterator: Optional[SentenceIterator] = None,
                 tokenizer_factory: Optional[TokenizerFactory] = None,
                 min_word_frequency: int = 1,
                 stop_words: Sequence[str] = ()):
        self.sentence_iterator = sentence_iterator
        self.tokenizer_factory = tokenizer_factory or DefaultTokenizerFactory()
        self.min_word_frequency = min_word_frequency
        self.stop_words = set(stop_words)
        self.vocab: Optional[VocabCache] = None
        self.n_docs = 0
        self._doc_freq: Optional[np.ndarray] = None

    def _tokens(self, text: str) -> List[str]:
        return [t for t in self.tokenizer_factory.create(text).get_tokens()
                if t not in self.stop_words]

    def fit(self):
        docs = []
        self.sentence_iterator.reset()
        while self.sentence_iterator.has_next():
            docs.append(self._tokens(self.sentence_iterator.next_sentence()))
        self.vocab = VocabConstructor(self.min_word_frequency).build_vocab(docs)
        self.n_docs = len(docs)
        V = self.vocab.num_words()
        df = np.zeros(V, np.float64)
        for toks in docs:
            for w in set(toks):
                i = self.vocab.index_of(w)
                if i >= 0:
                    df[i] += 1
        self._doc_freq = df
        return self

    def transform(self, text: str) -> np.ndarray:
        v = np.zeros(self.vocab.num_words(), np.float32)
        for t in self._tokens(text):
            i = self.vocab.index_of(t)
            if i >= 0:
                v[i] += 1.0
        return v

    def fit_transform(self) -> np.ndarray:
        self.fit()
        self.sentence_iterator.reset()
        rows = []
        while self.sentence_iterator.has_next():
            rows.append(self.transform(self.sentence_iterator.next_sentence()))
        return np.stack(rows) if rows else np.zeros((0, 0), np.float32)


class TfidfVectorizer(BagOfWordsVectorizer):
    def idf(self, word: str) -> float:
        i = self.vocab.index_of(word)
        if i < 0 or self._doc_freq[i] == 0:
            return 0.0
        return math.log(self.n_docs / self._doc_freq[i])

    def tfidf(self, word: str, count_in_doc: float, doc_len: float) -> float:
        tf = count_in_doc / max(doc_len, 1.0)
        return tf * self.idf(word)

    def transform(self, text: str) -> np.ndarray:
        toks = self._tokens(text)
        counts = np.zeros(self.vocab.num_words(), np.float32)
        for t in toks:
            i = self.vocab.index_of(t)
            if i >= 0:
                counts[i] += 1.0
        n = max(len(toks), 1)
        with np.errstate(divide="ignore"):
            idf = np.where(self._doc_freq > 0,
                           np.log(self.n_docs / np.maximum(self._doc_freq, 1)),
                           0.0)
        return (counts / n) * idf.astype(np.float32)
