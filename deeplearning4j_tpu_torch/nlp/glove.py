"""GloVe embeddings: the port of `deeplearning4j_tpu/nlp/glove.py`, under the
same names.

Parity with `models/glove/Glove.java` + the co-occurrence pipeline
(`glove/count/`, `CoOccurrenceCalculator`): windowed co-occurrence counts
with 1/d distance weighting, then AdaGrad-optimized weighted least squares
on log-counts:

    J = sum f(X_ij) (w_i . w~_j + b_i + b~_j - log X_ij)^2,
    f(x) = (x/x_max)^alpha clipped at 1

The co-occurrence matrix is built host-side (a dict), the shuffle is numpy
`default_rng(seed)` as in the JAX package, and each epoch's batches run as
one epoch of AdaGrad steps on the device (`embeddings._Epochs`: eager on
the CPU, replays of one captured step on the card).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..util.platform import DeviceLike, resolve_device
from .embeddings import InMemoryLookupTable, WordVectorsModel, _Epochs
from .sentence_iterator import SentenceIterator
from .tokenization import DefaultTokenizerFactory, TokenizerFactory
from .vocab import VocabCache, VocabConstructor

__all__ = ["Glove", "CoOccurrences"]

_KEYS = ("w", "wc", "b", "bc")


class CoOccurrences:
    """Symmetric windowed co-occurrence counts with 1/distance weighting
    (reference `glove/count/` + CoOccurrenceCalculator)."""

    def __init__(self, window: int = 15, symmetric: bool = True):
        self.window = int(window)
        self.symmetric = symmetric
        self.counts: Dict[Tuple[int, int], float] = {}

    def accumulate(self, idx: Sequence[int]):
        n = len(idx)
        for i in range(n):
            for off in range(1, self.window + 1):
                j = i + off
                if j >= n:
                    break
                w = 1.0 / off
                a, b = int(idx[i]), int(idx[j])
                self.counts[(a, b)] = self.counts.get((a, b), 0.0) + w
                if self.symmetric:
                    self.counts[(b, a)] = self.counts.get((b, a), 0.0) + w

    def triples(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        if not self.counts:
            return (np.zeros(0, np.int32),) * 2 + (np.zeros(0, np.float32),)
        ij = np.array(list(self.counts.keys()), np.int32)
        x = np.array(list(self.counts.values()), np.float32)
        return ij[:, 0], ij[:, 1], x


def _glove_loss(p, i, j, lx, f):
    pred = torch.sum(p["w"][i] * p["wc"][j], dim=-1) + p["b"][i] \
        + p["bc"][j]
    return torch.sum(f * (pred - lx) ** 2)


class Glove(WordVectorsModel):
    def __init__(self, sentence_iterator: Optional[SentenceIterator] = None,
                 tokenizer_factory: Optional[TokenizerFactory] = None,
                 layer_size: int = 100, window: int = 15,
                 min_word_frequency: int = 1, learning_rate: float = 0.05,
                 x_max: float = 100.0, alpha: float = 0.75,
                 epochs: int = 5, batch_size: int = 1024, seed: int = 12345,
                 symmetric: bool = True, device: DeviceLike = None):
        self.sentence_iterator = sentence_iterator
        self.tokenizer_factory = tokenizer_factory or DefaultTokenizerFactory()
        self.layer_size = int(layer_size)
        self.window = int(window)
        self.min_word_frequency = int(min_word_frequency)
        self.learning_rate = float(learning_rate)
        self.x_max = float(x_max)
        self.alpha = float(alpha)
        self.epochs = int(epochs)
        self.batch_size = int(batch_size)
        self.seed = int(seed)
        self.symmetric = symmetric
        self.device = resolve_device(device)
        self.vocab: Optional[VocabCache] = None
        self.lookup_table: Optional[InMemoryLookupTable] = None

    def _token_seqs(self) -> List[List[str]]:
        out = []
        self.sentence_iterator.reset()
        while self.sentence_iterator.has_next():
            s = self.sentence_iterator.next_sentence()
            out.append(self.tokenizer_factory.create(s).get_tokens())
        return out

    def _init_params(self, V: int, D: int) -> Dict[str, torch.Tensor]:
        """w and wc ~ U(-0.5/D, 0.5/D) from a generator on the device
        seeded with `seed`; zero biases."""
        g = torch.Generator(device=self.device).manual_seed(self.seed)
        p = {}
        for k in ("w", "wc"):
            p[k] = torch.empty((V, D), dtype=torch.float32,
                               device=self.device)
            p[k].uniform_(-0.5 / D, 0.5 / D, generator=g)
        p["b"] = torch.zeros(V, dtype=torch.float32, device=self.device)
        p["bc"] = torch.zeros(V, dtype=torch.float32, device=self.device)
        return p

    def fit(self):
        seqs = self._token_seqs()
        self.vocab = VocabConstructor(self.min_word_frequency).build_vocab(seqs)
        self.lookup_table = InMemoryLookupTable(
            self.vocab, self.layer_size, seed=self.seed, negative=0,
            device=self.device)
        co = CoOccurrences(self.window, self.symmetric)
        for toks in seqs:
            idx = [self.vocab.index_of(t) for t in toks]
            co.accumulate([i for i in idx if i >= 0])
        rows, cols, x = co.triples()
        if len(x) == 0:
            return self
        logx = np.log(x)
        fx = np.minimum(1.0, (x / self.x_max) ** self.alpha).astype(np.float32)

        V, D = self.vocab.num_words(), self.layer_size
        params = self._init_params(V, D)
        hist = {k: torch.full_like(params[k], 1e-8) for k in _KEYS}
        lr = self.learning_rate
        reduce = self._step_reduce()
        epochs = self._epochs = _Epochs("glove/epoch")

        def compute(r, _):
            leaves = {k: params[k].detach().requires_grad_(True)
                      for k in _KEYS}
            with torch.enable_grad():
                loss = _glove_loss(leaves, r["i"], r["j"], r["lx"], r["f"])
                gs = torch.autograd.grad(loss, [leaves[k] for k in _KEYS])
            return (loss.detach(),) + tuple(gs)

        def commit(outs):
            if reduce is not None:
                reduce(list(outs))
            for k, g in zip(_KEYS, outs[1:]):
                hist[k].add_(g * g)
                params[k].sub_(lr * g / torch.sqrt(hist[k]))

        rng = np.random.default_rng(self.seed)
        n = len(x)
        B = self._batch_round(self.batch_size)
        T = -(-n // B)
        for _ in range(self.epochs):
            perm = rng.permutation(n)
            # f = 0 padding triples: exact no-ops (every gradient term
            # carries the f weight)
            pad = T * B - n
            z = np.zeros(pad, np.int64)
            batch = {"i": np.concatenate([rows[perm], z]),
                     "j": np.concatenate([cols[perm], z]),
                     "lx": np.concatenate([logx[perm], z]),
                     "f": np.concatenate([fx[perm], z])}
            step_rows = {k: self._place(torch.as_tensor(
                v.reshape(T, B), dtype=torch.int64 if k in "ij"
                else torch.float32, device=self.device))
                for k, v in batch.items()}
            epochs(compute, commit, step_rows, T,
                   key=tuple(params[k].data_ptr() for k in _KEYS))
        # final embeddings: w + wc (standard GloVe)
        self.lookup_table.syn0 = params["w"] + params["wc"]
        return self

    # hooks for the distributed subclass (nlp/distributed.py)
    def _batch_round(self, B: int) -> int:
        return B

    def _place(self, arr):
        """This rank's share of an epoch's [T, B] batch rows."""
        return arr

    def _step_reduce(self):
        """The in-place sum of a step's loss and gradients over the data
        ranks (None: one device)."""
        return None
