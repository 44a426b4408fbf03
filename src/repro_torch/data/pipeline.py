"""Host-side batching and the synthetic LM corpus of the scaled schemes
— the port of `repro/data/pipeline.py`, in numpy, byte for byte the JAX
package's arrays for a seed. The JAX package's `sharded_batches` (each
batch placed on a mesh) has no counterpart: nothing in either package
calls it, and on one card a batch is whole on the card (ROADMAP.md).
"""
from __future__ import annotations

from typing import Iterator

import numpy as np

from repro_torch.models.encdec import src_len


def batches(x: np.ndarray, y: np.ndarray, batch_size: int, seed: int = 0,
            shuffle: bool = True, drop_last: bool = True) -> Iterator[dict]:
    n = len(x)
    rng = np.random.default_rng(seed)
    idx = rng.permutation(n) if shuffle else np.arange(n)
    stop = (n // batch_size) * batch_size if drop_last else n
    for i in range(0, stop, batch_size):
        j = idx[i:i + batch_size]
        yield {"tokens": x[j], "labels": y[j]}


def _zipf(vocab: int) -> np.ndarray:
    """Zipf(1.1) probabilities of the token ids 1 .. vocab - 1."""
    p = 1.0 / np.arange(1, vocab) ** 1.1
    return p / p.sum()


def synthetic_lm_batches(cfg, batch_size: int, seq_len: int,
                         seed: int = 0) -> Iterator[dict]:
    """Endless synthetic next-token batches of Zipf tokens (labels =
    tokens); a vision config's stub `patch_embeds` [batch, P, d_model]
    and an audio config's stub `frames` [batch, src_len, d_model], f32
    (0.1 x standard normals), come from the same stream, after each
    batch's tokens."""
    rng = np.random.default_rng(seed)
    vocab = cfg.vocab_size
    p = _zipf(vocab)
    while True:
        toks = 1 + rng.choice(vocab - 1, size=(batch_size, seq_len),
                              p=p).astype(np.int32)
        batch = {"tokens": toks, "labels": toks}
        if cfg.frontend == "vision":
            batch["patch_embeds"] = rng.standard_normal(
                (batch_size, cfg.n_frontend_tokens, cfg.d_model)
            ).astype(np.float32) * 0.1
        if cfg.family == "audio":
            batch["frames"] = rng.standard_normal(
                (batch_size, src_len(cfg, seq_len), cfg.d_model)
            ).astype(np.float32) * 0.1
        yield batch


def synthetic_corpus(cfg, n: int, seq_len: int, seed: int = 0):
    """Finite synthetic LM corpus for the scaled schemes: `n` Zipf token
    rows (the distribution of `synthetic_lm_batches`) with labels =
    tokens, as host arrays — the `Experiment` runner's `(x, y)`
    contract."""
    rng = np.random.default_rng(seed)
    vocab = cfg.vocab_size
    toks = 1 + rng.choice(vocab - 1, size=(n, seq_len),
                          p=_zipf(vocab)).astype(np.int32)
    return toks, toks.copy()

