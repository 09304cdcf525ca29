"""Tokenization SPI.

Parity with `deeplearning4j-nlp/.../text/tokenization/`:
  * Tokenizer / TokenizerFactory contracts
  * DefaultTokenizer (whitespace+punct), NGramTokenizer
  * token preprocessors: CommonPreprocessor (lowercase, strip punct),
    LowCasePreProcessor, EndingPreProcessor (crude stemmer)
  * stopwords list hook (`text/stopwords`)
"""
from __future__ import annotations

import re
from typing import Callable, List, Optional, Sequence

__all__ = [
    "Tokenizer", "TokenizerFactory", "DefaultTokenizer",
    "DefaultTokenizerFactory", "NGramTokenizer", "NGramTokenizerFactory",
    "CommonPreprocessor", "LowCasePreProcessor", "EndingPreProcessor",
    "STOP_WORDS",
]

STOP_WORDS = {
    "a", "an", "and", "are", "as", "at", "be", "but", "by", "for", "if",
    "in", "into", "is", "it", "no", "not", "of", "on", "or", "such", "that",
    "the", "their", "then", "there", "these", "they", "this", "to", "was",
    "will", "with", "he", "she", "his", "her", "its", "had", "has", "have",
}


class CommonPreprocessor:
    """Lowercase + strip punctuation (reference CommonPreprocessor)."""

    _PUNCT = re.compile(r"[\d.:,\"'()\[\]|/?!;]+")

    def pre_process(self, token: str) -> str:
        return self._PUNCT.sub("", token.lower())


class LowCasePreProcessor:
    def pre_process(self, token: str) -> str:
        return token.lower()


class EndingPreProcessor:
    """Crude suffix stripper (reference EndingPreProcessor)."""

    def pre_process(self, token: str) -> str:
        for suf in ("sses", "ies", "ed", "ing", "ly", "s"):
            if token.endswith(suf) and len(token) > len(suf) + 2:
                if suf == "sses":
                    return token[:-2]
                if suf == "ies":
                    return token[:-3] + "y"
                return token[: -len(suf)]
        return token


class Tokenizer:
    """Iterator-style tokenizer contract (reference Tokenizer interface)."""

    def __init__(self, tokens: List[str],
                 preprocessor: Optional[object] = None):
        self._tokens = tokens
        self._pos = 0
        self._pre = preprocessor

    def set_token_pre_processor(self, pre):
        self._pre = pre

    def has_more_tokens(self) -> bool:
        return self._pos < len(self._tokens)

    def count_tokens(self) -> int:
        return len(self._tokens)

    def next_token(self) -> str:
        t = self._tokens[self._pos]
        self._pos += 1
        return self._pre.pre_process(t) if self._pre else t

    def get_tokens(self) -> List[str]:
        if self._pre is None and self._pos == 0:  # fast path: no per-token
            return list(self._tokens)             # preprocessor calls
        out = []
        while self.has_more_tokens():
            t = self.next_token()
            if t:
                out.append(t)
        return out


class TokenizerFactory:
    def create(self, text: str) -> Tokenizer:
        raise NotImplementedError

    def set_token_pre_processor(self, pre):
        self._pre = pre


class DefaultTokenizer(Tokenizer):
    def __init__(self, text: str, preprocessor=None):
        # str.split() == whitespace-regex split, ~3x faster on the vocab-build
        # hot path
        super().__init__(text.split(), preprocessor)


class DefaultTokenizerFactory(TokenizerFactory):
    def __init__(self):
        self._pre = None

    def create(self, text: str) -> Tokenizer:
        return DefaultTokenizer(text, self._pre)


class NGramTokenizer(Tokenizer):
    """Word n-grams joined by spaces (reference NGramTokenizer)."""

    def __init__(self, text: str, min_n: int, max_n: int, preprocessor=None):
        base = DefaultTokenizer(text, preprocessor).get_tokens()
        toks = []
        for n in range(min_n, max_n + 1):
            for i in range(len(base) - n + 1):
                toks.append(" ".join(base[i:i + n]))
        super().__init__(toks, None)


class NGramTokenizerFactory(TokenizerFactory):
    def __init__(self, min_n: int = 1, max_n: int = 2):
        self._pre = None
        self.min_n, self.max_n = min_n, max_n

    def create(self, text: str) -> Tokenizer:
        return NGramTokenizer(text, self.min_n, self.max_n, self._pre)
