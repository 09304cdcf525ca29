"""JAX's device-side draws for the port's word-vector models.

The port draws its negatives, its SGNS center positions and reduced
windows, and `infer_vector`'s start vector and negatives from a
`torch.Generator` through three methods of its models (`_pair_negatives`,
`_sg_draws`, `_infer_draws`). `JaxDraws` overrides them with the draws the
JAX package makes for the same model, key for key: a port model with this
mixin, started from JAX's tables (`InMemoryLookupTable.from_arrays`),
trains on exactly JAX's stream. Host-side draws (vocabulary, pairs,
shuffles) are numpy in both packages already.

Set `jax_sampler` (the JAX table's `NegativeSampler`) before `fit`."""
import numpy as np
import torch

import jax
import jax.numpy as jnp

import deeplearning4j_tpu_torch.nlp as pnlp
from deeplearning4j_tpu_torch.nlp.embeddings import (InMemoryLookupTable,
                                                     pad_scan_length)


def as_torch(a, device):
    return torch.as_tensor(np.array(a), dtype=torch.int64, device=device)


def jax_pair_negatives(sampler, key, T, B, K):
    """The negatives of JAX's pair epoch for one task: `keys =
    split(key, pad_scan_length(T))`, step t's `sampler.sample(keys[t], (B,
    K))` (the padded steps' draws are never used)."""
    keys = jax.random.split(key, pad_scan_length(T))[:T]
    return np.asarray(jax.vmap(lambda k: sampler.sample(k, (B, K)))(keys))


def jax_sg_draws(key, n, T, B, W):
    """One SGNS epoch of JAX's `_fit_sg_corpus` from the fit's running
    key: (key', positions [T, B], windows [T, B])."""
    T2 = pad_scan_length(T)
    key, pk = jax.random.split(key)
    perm = jax.random.permutation(pk, n)
    reps = -(-T2 * B // n)
    pos = np.asarray(jnp.tile(perm, reps)[:T2 * B].reshape(T2, B)[:T])
    key, k = jax.random.split(key)
    keys = jax.random.split(k, T2)[:T]
    b = np.asarray(jax.vmap(
        lambda kk: jax.random.randint(kk, (B,), 1, W + 1))(keys))
    return key, pos, b


def jax_corpus_windows(key, T, B, W):
    """The reduced windows JAX's corpus runner draws inside its scan from
    `run(..., rng=key)` over T steps."""
    keys = jax.random.split(key, T)
    return np.asarray(jax.vmap(
        lambda kk: jax.random.randint(kk, (B,), 1, W + 1))(keys))


def stable_hash(text):
    """A hash of `text` that PYTHONHASHSEED does not change."""
    import hashlib
    return int.from_bytes(hashlib.sha256(text.encode()).digest()[:8],
                          "little", signed=True)


def jax_text_seed(text):
    """The seed JAX's `infer_vector` takes for `text`: `abs(hash(text)) %
    2**31`, through the `hash` its module sees (a test may give the module
    `stable_hash`, so that the draws do not change between processes)."""
    from deeplearning4j_tpu.nlp import word2vec as jw2v
    return abs(getattr(jw2v, "hash", hash)(text)) % (2 ** 31)


class JaxDraws:
    jax_sampler = None

    def fit(self, *a, **kw):
        self._jrng_pair = jax.random.PRNGKey(self.seed)
        return super().fit(*a, **kw)

    def _pair_negatives(self, gen, table, T, B, K):
        self._jrng_pair, k = jax.random.split(self._jrng_pair)
        return as_torch(jax_pair_negatives(self.jax_sampler, k, T, B, K),
                        table.device)

    def _sg_draws(self, gen, n, T, B):
        idx = self._sg_fit_count - 1
        if getattr(self, "_jsg_idx", None) != idx:
            self._jsg_idx = idx
            self._jrng_sg = jax.random.fold_in(
                jax.random.PRNGKey(self.seed), idx)
        self._jrng_sg, pos, b = jax_sg_draws(self._jrng_sg, n, T, B,
                                             self.window_size)
        return as_torch(pos, self.device), as_torch(b, self.device)

    def _infer_draws(self, text, n_words, steps):
        """JAX's `infer_vector` draws from its `abs(hash(text))` seed
        (`jax_text_seed`)."""
        D = self.layer_size
        rng = jax.random.PRNGKey(jax_text_seed(text))
        vec = jax.random.uniform(rng, (D,), jnp.float32, -0.5 / D, 0.5 / D)
        negs = []
        for _ in range(steps):
            rng, k = jax.random.split(rng)
            negs.append(np.asarray(self.jax_sampler.sample(
                k, (n_words, max(1, self.lookup_table.negative)))))
        dev = self.lookup_table.device
        return (torch.as_tensor(np.array(vec), device=dev),
                as_torch(np.stack(negs), dev))


def carry(jm, pm):
    """The JAX model's tables into the port model (built vocab), and JAX's
    sampler for `JaxDraws`."""
    jt = jm.lookup_table
    pm.lookup_table = InMemoryLookupTable.from_arrays(
        pm.vocab, np.asarray(jt.syn0),
        None if jt.syn1 is None else np.asarray(jt.syn1),
        None if jt.syn1neg is None else np.asarray(jt.syn1neg),
        use_hs=jt.use_hs, negative=jt.negative,
        hs=((np.asarray(jt.hs_codes), np.asarray(jt.hs_points),
             np.asarray(jt.hs_mask)) if jt.use_hs else None),
        device="cpu")
    pm.jax_sampler = jt.sampler


class JaxInitGlove(pnlp.Glove):
    """A port GloVe starting from JAX's initial w / wc (JAX's fit draws
    them from split(PRNGKey(seed)))."""

    def _init_params(self, V, D):
        k1, k2 = jax.random.split(jax.random.PRNGKey(self.seed))
        p = {"w": jax.random.uniform(k1, (V, D), jnp.float32, -0.5 / D,
                                     0.5 / D),
             "wc": jax.random.uniform(k2, (V, D), jnp.float32, -0.5 / D,
                                      0.5 / D)}
        out = {k: torch.as_tensor(np.array(v)) for k, v in p.items()}
        out.update(b=torch.zeros(V), bc=torch.zeros(V))
        return out
