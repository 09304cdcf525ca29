"""SequenceVectors engine + Word2Vec + ParagraphVectors: the port of
`deeplearning4j_tpu/nlp/word2vec.py`, under the same names.

Parity with:
  * SequenceVectors (`models/sequencevectors/SequenceVectors.java:51`): the
    generic trainer over element sequences (words, labelled docs, graph
    walks), with elements_learning_algorithm (SkipGram/CBOW) and
    sequence_learning_algorithm (DBOW/DM);
  * Word2Vec (`models/word2vec/Word2Vec.java:32`): layer size, window, min
    word frequency, negative sampling, HS, subsampling, lr linear decay to
    min_learning_rate;
  * ParagraphVectors (`models/paragraphvectors/ParagraphVectors.java`):
    DBOW/DM with label vectors in the shared lookup table + `infer_vector`
    for unseen documents.

Host-side work (vocabulary, pair generation, subsampling, shuffles of the
pair path) draws from numpy's `default_rng(seed)` in the JAX package's
order, so it is the same in both packages. Device-side draws (the corpus
path's center positions and reduced windows, the negatives) come from a
`torch.Generator` on the model's device seeded from `seed`, through the
`_sg_draws` / `_pair_negatives` / `_infer_draws` methods (a test hands
JAX's draws through them). Every entry point takes `device=` (the GPU when
left out; a missing GPU raises).
"""
from __future__ import annotations

import hashlib
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..telemetry.compile_watch import watch_compiles
from ..telemetry.runtime import active as _tel_active, null_span as _null_span
from ..util.platform import DeviceLike, resolve_device
from .embeddings import (InMemoryLookupTable, WordVectorsModel,
                         make_cbow_step, make_epoch_runner,
                         make_skipgram_corpus_runner, make_skipgram_step)
from .sentence_iterator import (BasicLabelAwareIterator, LabelAwareIterator,
                                SentenceIterator)
from .tokenization import DefaultTokenizerFactory, TokenizerFactory
from .vocab import VocabCache, VocabConstructor

__all__ = ["SequenceVectors", "Word2Vec", "ParagraphVectors"]


def _fold_in(seed: int, i: int) -> int:
    """A generator seed for draw stream `i` of `seed` (JAX's
    `fold_in(PRNGKey(seed), i)`: distinct streams per fit)."""
    return int(np.random.SeedSequence([int(seed) & 0xFFFFFFFF, int(i)])
               .generate_state(1, np.uint64)[0] >> 1)


class SequenceVectors(WordVectorsModel):
    """Generic embedding trainer over sequences of string elements."""

    def __init__(self,
                 layer_size: int = 100,
                 window_size: int = 5,
                 min_word_frequency: int = 1,
                 learning_rate: float = 0.025,
                 min_learning_rate: float = 1e-4,
                 negative: int = 5,
                 use_hierarchic_softmax: bool = False,
                 sampling: float = 0.0,
                 epochs: int = 1,
                 batch_size: int = 512,
                 seed: int = 12345,
                 elements_learning_algorithm: str = "skipgram",
                 sequence_learning_algorithm: str = "dbow",
                 train_elements: bool = True,
                 train_sequences: bool = False,
                 device: DeviceLike = None):
        self.layer_size = int(layer_size)
        self.window_size = int(window_size)
        self.min_word_frequency = int(min_word_frequency)
        self.learning_rate = float(learning_rate)
        self.min_learning_rate = float(min_learning_rate)
        self.negative = int(negative)
        self.use_hs = bool(use_hierarchic_softmax)
        self.sampling = float(sampling)
        self.epochs = int(epochs)
        self.batch_size = int(batch_size)
        self.seed = int(seed)
        self.elements_algo = elements_learning_algorithm.lower()
        self.sequence_algo = sequence_learning_algorithm.lower()
        self.train_elements = train_elements
        self.train_sequences = train_sequences
        self.device = resolve_device(device)
        self.vocab: Optional[VocabCache] = None
        self.lookup_table: Optional[InMemoryLookupTable] = None
        self._np_rng = np.random.default_rng(seed)

    # -- corpus plumbing (overridden by subclasses) ---------------------
    def _sequences(self) -> Iterable[Tuple[List[str], List[str]]]:
        """Yield (tokens, labels) pairs."""
        raise NotImplementedError

    # ------------------------------------------------------------------
    def build_vocab(self):
        seqs = list(self._sequences())
        self.vocab = VocabConstructor(self.min_word_frequency).build_vocab(
            (toks for toks, _ in seqs), (labels for _, labels in seqs))
        self.lookup_table = InMemoryLookupTable(
            self.vocab, self.layer_size, seed=self.seed,
            use_hs=self.use_hs, negative=self.negative, device=self.device)
        return seqs

    def _keep_probs(self, idx: np.ndarray) -> np.ndarray:
        """Frequent-word subsampling keep-probability (reference `sampling`
        config): one definition for both training paths."""
        counts = self.vocab.counts_array()
        freq = counts[idx] / counts.sum()
        return np.minimum(1.0, np.sqrt(self.sampling / freq)
                          + self.sampling / freq)

    def _subsample(self, idx: np.ndarray) -> np.ndarray:
        if self.sampling <= 0:
            return idx
        return idx[self._np_rng.random(len(idx)) < self._keep_probs(idx)]

    def _to_indices(self, tokens: Sequence[str]) -> np.ndarray:
        idx = [self.vocab.index_of(t) for t in tokens]
        return np.array([i for i in idx if i >= 0], np.int32)

    def _flatten_corpus(self, seqs, subsample: bool = True):
        """Flatten the corpus to (word_indices, sentence_ids), optionally
        with subsampling applied: the SGNS corpus runner's input. One pass
        of dict lookups over all tokens, then numpy."""
        g = {w: vw.index for w, vw in self.vocab._words.items()}.get
        flat = np.fromiter((g(t, -1) for toks, _ in seqs for t in toks),
                           np.int32)
        lens = np.fromiter((len(toks) for toks, _ in seqs), np.int64)
        sid = np.repeat(np.arange(len(lens), dtype=np.int32), lens)
        keep = flat >= 0
        flat, sid = flat[keep], sid[keep]
        if subsample and self.sampling > 0 and len(flat):
            m = self._np_rng.random(len(flat)) < self._keep_probs(flat)
            flat, sid = flat[m], sid[m]
        return flat, sid

    def _gen_pairs_sg_fast(self, seqs) -> Dict[str, np.ndarray]:
        """Vectorized skip-gram pair generation: the corpus flattened into
        one index array with sentence ids, and for each window offset d the
        (center, context) pairs from boolean masks, keeping the per-center
        random reduced window b ~ U[1, W] of `SkipGram.java`."""
        flat_parts, sid_parts = [], []
        for si, (tokens, _labels) in enumerate(seqs):
            idx = self._subsample(self._to_indices(tokens))
            if len(idx) < 2:
                continue
            flat_parts.append(idx)
            sid_parts.append(np.full(len(idx), si, np.int64))
        if not flat_parts:
            return {}
        flat = np.concatenate(flat_parts)
        sid = np.concatenate(sid_parts)
        n = len(flat)
        W = self.window_size
        b = self._np_rng.integers(1, W + 1, n)
        centers, ctxs = [], []
        for d in range(1, W + 1):
            same = sid[:-d] == sid[d:]
            right = same & (d <= b[:-d])   # center i  -> context i+d
            left = same & (d <= b[d:])     # center i+d -> context i
            centers.append(flat[:-d][right])
            ctxs.append(flat[d:][right])
            centers.append(flat[d:][left])
            ctxs.append(flat[:-d][left])
        c = np.concatenate(centers).astype(np.int32)
        x = np.concatenate(ctxs).astype(np.int32)
        return {"sg": (c, x)} if len(c) else {}

    def _gen_pairs(self, seqs) -> Dict[str, np.ndarray]:
        """Generate training examples host-side (vectorized per sentence)."""
        if (self.train_elements and not self.train_sequences
                and self.elements_algo == "skipgram"):
            return self._gen_pairs_sg_fast(seqs)
        sg_c, sg_x = [], []
        cb_c, cb_x = [], []
        seq_c, seq_x = [], []
        W = self.window_size
        cbow = self.elements_algo == "cbow"
        dm = self.sequence_algo == "dm"
        for tokens, labels in seqs:
            idx = self._subsample(self._to_indices(tokens))
            n = len(idx)
            if n < 2 and not labels:
                continue
            label_idx = [self.vocab.index_of(l) for l in labels]
            label_idx = [i for i in label_idx if i >= 0]
            bs = self._np_rng.integers(1, W + 1, n) if n else np.zeros(0, int)
            for i in range(n):
                b = bs[i]
                lo, hi = max(0, i - b), min(n, i + b + 1)
                ctx = np.concatenate([idx[lo:i], idx[i + 1:hi]])
                if len(ctx) == 0:
                    continue
                if self.train_elements:
                    if cbow:
                        pad = np.full(2 * W, -1, np.int32)
                        pad[:len(ctx)] = ctx[:2 * W]
                        cb_c.append(idx[i])
                        cb_x.append(pad)
                    else:
                        for c in ctx:
                            sg_c.append(idx[i])
                            sg_x.append(c)
                if self.train_sequences and label_idx:
                    if dm:
                        # DM: doc vector joins the averaged context
                        pad = np.full(2 * W + 1, -1, np.int32)
                        pad[:min(len(ctx), 2 * W)] = ctx[:2 * W]
                        pad[-1] = label_idx[0]
                        seq_c.append(idx[i])
                        seq_x.append(pad)
                    else:
                        # DBOW: doc vector predicts each word
                        for l in label_idx:
                            seq_c.append(l)
                            seq_x.append(idx[i])
        out = {}
        if sg_c:
            out["sg"] = (np.array(sg_c, np.int32), np.array(sg_x, np.int32))
        if cb_c:
            out["cb"] = (np.array(cb_c, np.int32), np.stack(cb_x))
        if seq_c:
            if dm:
                out["dm"] = (np.array(seq_c, np.int32), np.stack(seq_x))
            else:
                out["dbow"] = (np.array(seq_c, np.int32),
                               np.array(seq_x, np.int32))
        return out

    # ------------------------------------------------------------------
    def _corpus_key(self):
        """Identity of the token source: a new vocab, a swapped iterator,
        or a swapped tokenizer invalidates the flattened-corpus cache. The
        key holds STRONG references (compared by identity), so a reused id
        can never produce a false hit. In-place mutation of the collection
        behind an unchanged iterator object is not detectable: call
        reset_corpus_cache() after doing that."""
        src = getattr(self, "sentence_iterator", None)
        if src is None:
            src = getattr(self, "iterator", None)
        return (self.vocab, src, getattr(self, "tokenizer_factory", None))

    @staticmethod
    def _same_key(a, b) -> bool:
        return (a is not None and b is not None and len(a) == len(b)
                and all(x is y for x, y in zip(a, b)))

    def reset_corpus_cache(self):
        """Drop the cached flattened corpus (next fit re-tokenizes)."""
        self._sg_flat_cache = None

    def _tensor(self, a, dtype=torch.int64):
        return torch.as_tensor(np.asarray(a), dtype=dtype,
                               device=self.device)

    def fit(self):
        sg_fast = (self.train_elements and not self.train_sequences
                   and self.elements_algo == "skipgram" and not self.use_hs
                   and self.negative > 0)
        if self.vocab is None:
            seqs = self.build_vocab()
        elif (sg_fast and getattr(self, "_sg_flat_cache", None) is not None
                and self._same_key(self._sg_flat_cache[0],
                                   self._corpus_key())):
            # steady-state epochs on an unchanged corpus: skip host
            # re-tokenization (equivalent to epochs=N in one fit)
            seqs = None
        else:
            seqs = list(self._sequences())
        table = self.lookup_table
        if sg_fast:
            return self._fit_sg_corpus(seqs)
        sg_step = make_skipgram_step(table)
        cb_step = (make_cbow_step(table, self.window_size)
                   if (self.elements_algo == "cbow"
                       or self.sequence_algo == "dm") else None)
        gen = torch.Generator(device=table.device).manual_seed(self.seed)
        K = table.negative
        placeholder = torch.zeros((1, 1), dtype=torch.float32,
                                  device=table.device)
        syn0 = table.syn0
        syn1 = table.syn1 if table.syn1 is not None else placeholder
        syn1neg = table.syn1neg if table.syn1neg is not None else placeholder

        tel = _tel_active()
        span = tel.span if tel is not None else _null_span
        reduce = self._step_reduce()
        runners = {}
        self._pair_runners = {}
        for epoch in range(self.epochs):
            with span("host/pair_gen"):
                pairs = self._gen_pairs(seqs)
            tasks = []
            if "sg" in pairs:
                tasks.append(("sg", sg_step) + pairs["sg"])
            if "cb" in pairs:
                tasks.append(("cb", cb_step) + pairs["cb"])
            if "dm" in pairs:
                # DM trains through the cbow step with doc in context
                dm_step = cb_step or make_cbow_step(table, self.window_size)
                tasks.append(("dm", dm_step) + pairs["dm"])
            if "dbow" in pairs:
                tasks.append(("dbow", sg_step) + pairs["dbow"])
            total = sum(len(t[2]) for t in tasks) * self.epochs or 1
            done = epoch * (total // self.epochs)
            for kind, step, centers, contexts in tasks:
                n = len(centers)
                perm = self._np_rng.permutation(n)
                centers, contexts = centers[perm], contexts[perm]
                B = self._pair_round_batch(self.batch_size)
                pad = (-n) % B
                if pad:
                    centers = np.concatenate([centers, centers[:pad]])
                    if contexts.ndim == 1:
                        contexts = np.concatenate([contexts, contexts[:pad]])
                    else:
                        contexts = np.concatenate([contexts, contexts[:pad]],
                                                  axis=0)
                T = len(centers) // B
                # per-step lr keeps the reference's linear decay to
                # min_learning_rate (JAX's padded lr-0 steps are not run)
                frac = np.minimum(1.0, (done + np.arange(T) * B) / total)
                lrs = np.maximum(self.min_learning_rate,
                                 self.learning_rate * (1.0 - frac))
                negatives = (self._pair_negatives(gen, table, T, B, K)
                             if K > 0 else None)
                runner = runners.get(kind)
                if runner is None:
                    raw = self._pair_runners[kind] = make_epoch_runner(
                        step, reduce, f"word2vec/{kind}_epoch")
                    runner = runners[kind] = self._watched(
                        raw, f"word2vec/{kind}_epoch")
                with span("device/dispatch", kind=f"w2v_{kind}_epoch"):
                    runner(syn0, syn1, syn1neg,
                           self._pair_place(self._tensor(
                               centers.reshape((T, B)))),
                           self._pair_place(self._tensor(contexts.reshape(
                               (T, B) + contexts.shape[1:]))),
                           self._tensor(lrs, torch.float32),
                           None if negatives is None
                           else self._pair_place(negatives))
                done += T * B
        return self

    def _watched(self, runner, name):
        """The CPU's epochs count a compile per new signature, where the
        card captures (the card's runner records its captures itself)."""
        if self.device.type == "cuda":
            return runner
        return watch_compiles(runner, name)

    def _pair_negatives(self, gen, table, T: int, B: int, K: int):
        """The pair path's negatives for an epoch of one task, [T, B, K],
        drawn from the unigram^0.75 sampler."""
        return table.sampler.sample(gen, (T, B, K))

    def _fit_sg_corpus(self, seqs):
        """SGNS fast path: corpus on the device, windows gathered and the
        expected-NS update applied inside each step (see
        make_skipgram_corpus_runner)."""
        tel = _tel_active()
        span = tel.span if tel is not None else _null_span
        table = self.lookup_table
        runner_key = (id(table), self.window_size)
        if getattr(self, "_sg_runner_key", None) != runner_key:
            self._sg_runner = make_skipgram_corpus_runner(
                table, self.window_size, self._step_reduce())
            self._sg_call = self._watched(self._sg_runner,
                                          "word2vec/sgns_epoch")
            self._sg_runner_key = runner_key
        # fold the per-model fit count into the stream so incremental fits
        # continue training with fresh shuffles and windows
        fit_idx = getattr(self, "_sg_fit_count", 0)
        self._sg_fit_count = fit_idx + 1
        gen = torch.Generator(device=table.device).manual_seed(
            _fold_in(self.seed, fit_idx))
        syn0, syn1neg = table.syn0, table.syn1neg
        # batch_size counts PAIRS (as in the pair path); a center yields
        # ~window pairs, so derive centers-per-step from it, capped by the
        # vocab size (batched-sum SGD diverges when one row accumulates many
        # stale-parameter pair gradients in one step)
        B = max(32, self.batch_size // max(1, self.window_size))
        B = min(B, max(32, self.vocab.num_words()))
        B = self._sg_round_batch(B)
        # flatten ONCE; per-epoch subsampling only re-draws the keep mask
        # over the fixed index array. Cached across fit() calls for an
        # unchanged (vocab, iterator)
        key = self._corpus_key()
        cache = getattr(self, "_sg_flat_cache", None)
        if seqs is None and cache is not None and self._same_key(cache[0],
                                                                 key):
            base_flat, base_sid = cache[1], cache[2]
        else:
            with span("host/flatten_corpus"):
                base_flat, base_sid = self._flatten_corpus(seqs,
                                                           subsample=False)
            self._sg_flat_cache = (key, base_flat, base_sid)
        if len(base_flat) < 2:
            return self
        keep_p = self._keep_probs(base_flat) if self.sampling > 0 else None
        corpus_dev = None  # device-resident when subsampling is off
        for epoch in range(self.epochs):
            if corpus_dev is None or keep_p is not None:
                if keep_p is not None:
                    m = self._np_rng.random(len(base_flat)) < keep_p
                    flat, sid = base_flat[m], base_sid[m]
                else:
                    flat, sid = base_flat, base_sid
                if len(flat) < 2:
                    continue
                corpus_dev = (self._tensor(flat), self._tensor(sid))
            n = int(corpus_dev[0].shape[0])
            T = max(1, (n + B - 1) // B)
            positions, windows = self._sg_draws(gen, n, T, B)
            # linear decay normalized by SEEN (post-filter) tokens so the lr
            # reaches min_learning_rate by the last epoch
            frac = np.minimum(
                1.0, (epoch + np.arange(T) * B / n) / self.epochs)
            lrs = np.maximum(self.min_learning_rate,
                             self.learning_rate * (1.0 - frac))
            with span("device/dispatch", kind="w2v_sgns_epoch"):
                self._sg_call(syn0, syn1neg, corpus_dev[0], corpus_dev[1],
                              self._sg_place_positions(positions),
                              self._sg_place_positions(windows),
                              self._tensor(lrs, torch.float32))
        return self

    def _sg_draws(self, gen, n: int, T: int, B: int):
        """An epoch's shuffled center positions [T, B] (a permutation of the
        n corpus positions, wrapped to fill the last step) and each
        center's reduced window b ~ U[1, W] [T, B], drawn on the device."""
        perm = torch.randperm(n, generator=gen, device=self.device)
        reps = -(-T * B // n)
        positions = perm.repeat(reps)[:T * B].view(T, B)
        windows = torch.randint(1, self.window_size + 1, (T, B),
                                generator=gen, device=self.device)
        return positions, windows

    # hooks for the distributed subclasses (nlp/distributed.py)
    def _sg_round_batch(self, B: int) -> int:
        return B

    def _sg_place_positions(self, pos):
        """This rank's share of an SGNS epoch's [T, B] rows."""
        return pos

    def _pair_round_batch(self, B: int) -> int:
        """Pair-path (sg/cbow/dbow/dm) batch rounding hook."""
        return B

    def _pair_place(self, arr):
        """This rank's share of a pair-path batch ([T, B, ...] arrays)."""
        return arr

    def _step_reduce(self):
        """The in-place sum of a step's loss and gradients over the data
        ranks (None: one device)."""
        return None


class Word2Vec(SequenceVectors):
    """Reference builder parity: Word2Vec.Builder().layerSize(..)
    .windowSize(..) ... here as constructor kwargs."""

    def __init__(self, sentence_iterator: Optional[SentenceIterator] = None,
                 tokenizer_factory: Optional[TokenizerFactory] = None,
                 **kw):
        kw.setdefault("train_elements", True)
        kw.setdefault("train_sequences", False)
        super().__init__(**kw)
        self.sentence_iterator = sentence_iterator
        self.tokenizer_factory = tokenizer_factory or DefaultTokenizerFactory()

    def _sequences(self):
        self.sentence_iterator.reset()
        while self.sentence_iterator.has_next():
            s = self.sentence_iterator.next_sentence()
            yield self.tokenizer_factory.create(s).get_tokens(), []


class ParagraphVectors(SequenceVectors):
    """DBOW/DM document embeddings; labels live in the shared vocab/lookup
    (reference ParagraphVectors)."""

    def __init__(self, iterator: Optional[LabelAwareIterator] = None,
                 sentence_iterator: Optional[SentenceIterator] = None,
                 tokenizer_factory: Optional[TokenizerFactory] = None,
                 **kw):
        kw.setdefault("train_elements", False)
        kw.setdefault("train_sequences", True)
        super().__init__(**kw)
        if iterator is None and sentence_iterator is not None:
            iterator = BasicLabelAwareIterator(sentence_iterator)
        self.iterator = iterator
        self.tokenizer_factory = tokenizer_factory or DefaultTokenizerFactory()

    def _sequences(self):
        self.iterator.reset()
        while self.iterator.has_next_document():
            doc = self.iterator.next_document()
            toks = self.tokenizer_factory.create(doc.content).get_tokens()
            yield toks, list(doc.labels)

    # -- label-space queries -------------------------------------------
    def labels(self) -> List[str]:
        return [vw.word for vw in self.vocab.vocab_words() if vw.is_label]

    def label_vector(self, label: str) -> Optional[np.ndarray]:
        return self.word_vector(label)

    def nearest_labels(self, vec_or_text, top_n: int = 10) -> List[str]:
        if isinstance(vec_or_text, str):
            vec = self.infer_vector(vec_or_text)
        else:
            vec = np.asarray(vec_or_text)
        m = self.lookup_table.vectors_matrix()
        sims = {}
        for vw in self.vocab.vocab_words():
            if not vw.is_label:
                continue
            v = m[vw.index]
            d = np.linalg.norm(v) * (np.linalg.norm(vec) + 1e-12)
            sims[vw.word] = float(v @ vec / d) if d else 0.0
        return sorted(sims, key=sims.get, reverse=True)[:top_n]

    def _infer_draws(self, text: str, n_words: int, steps: int):
        """`infer_vector`'s start vector [D] ~ U(-0.5/D, 0.5/D) and its
        negatives [steps, n_words, max(1, K)], from a generator seeded by a
        digest of the text (JAX seeds from `hash(text)`, which changes with
        PYTHONHASHSEED)."""
        D = self.layer_size
        table = self.lookup_table
        seed = int.from_bytes(hashlib.sha256(text.encode("utf-8"))
                              .digest()[:4], "little") % (2 ** 31)
        gen = torch.Generator(device=table.device).manual_seed(seed)
        vec = torch.empty(D, dtype=torch.float32, device=table.device)
        vec.uniform_(-0.5 / D, 0.5 / D, generator=gen)
        negs = table.sampler.sample(gen, (steps, n_words,
                                          max(1, table.negative)))
        return vec, negs

    def infer_vector(self, text: str, steps: int = 20,
                     learning_rate: float = 0.025) -> np.ndarray:
        """Train a fresh doc vector against the FROZEN tables (reference
        `inferVector`)."""
        toks = self.tokenizer_factory.create(text).get_tokens()
        idx = self._to_indices(toks)
        if len(idx) == 0:
            return np.zeros(self.layer_size, np.float32)
        table = self.lookup_table
        if table.negative <= 0:
            raise ValueError("infer_vector needs negative sampling "
                             "(negative > 0): it trains against syn1neg")
        vec, negs = self._infer_draws(text, len(idx), steps)
        words = self._tensor(idx)
        up = table.syn1neg[words]                        # [N, D]

        def loss_fn(v, neg):
            # DBOW inference: doc vector predicts each observed word
            pos = F.logsigmoid(up @ v)
            un = table.syn1neg[neg]                      # [N, K, D]
            nl = torch.sum(F.logsigmoid(-torch.einsum("d,nkd->nk", v, un)),
                           dim=-1)
            return -torch.sum(pos + nl)

        for t in range(steps):
            lr = np.float32(learning_rate * (1.0 - t / steps))
            v = vec.detach().requires_grad_(True)
            with torch.enable_grad():
                g, = torch.autograd.grad(loss_fn(v, negs[t]), [v])
            vec = vec - float(lr) * g
        return vec.detach().cpu().numpy()
