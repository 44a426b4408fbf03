"""Synthetic Sentiment140-style corpus — a numpy-only copy of
`repro/data/sentiment.py` (the same arrays for the same seed).

The 1.6M-tweet Sentiment140 corpus [Go et al. 2009] is replaced by a
statistically matched synthetic generator: binary labels, a 10,000-token
vocabulary (paper Table I), fixed max length 30. Token sequences are a mixture of a shared "neutral" Zipf background and a
class-conditional sentiment lexicon, so the classification task is
learnable but not trivial (lexicon tokens appear in both classes with
asymmetric odds, and sequences vary in how many lexicon slots they carry).
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class SentimentConfig:
    vocab_size: int = 10_000
    seq_len: int = 30
    n_lexicon: int = 40           # sentiment-bearing tokens per class
    # (real tweets carry sentiment in a few dozen FREQUENT words —
    # "good", "love", "hate"… — so a compact high-frequency lexicon is
    # the realistic choice, and is also what makes the task learnable
    # with the paper's plain SGD at reduced corpus scale)
    lexicon_rate: float = 0.18    # expected fraction of lexicon slots
    class_purity: float = 0.82    # p(lexicon token matches the label)
    zipf_a: float = 1.2
    pad_id: int = 0


def _zipf_probs(cfg: SentimentConfig) -> np.ndarray:
    ranks = np.arange(1, cfg.vocab_size)
    p = 1.0 / ranks ** cfg.zipf_a
    return p / p.sum()


def make_dataset(n: int, seed: int, cfg: SentimentConfig = SentimentConfig()):
    """Returns (tokens [n, seq_len] int32, labels [n] int32)."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, 2, size=n).astype(np.int32)

    background = _zipf_probs(cfg)
    # token id ranges: [1, n_lex] = negative lexicon, (n_lex, 2*n_lex] = positive
    neg_lex = np.arange(1, cfg.n_lexicon + 1)
    pos_lex = np.arange(cfg.n_lexicon + 1, 2 * cfg.n_lexicon + 1)

    tokens = 1 + rng.choice(cfg.vocab_size - 1, size=(n, cfg.seq_len),
                            p=background).astype(np.int32)
    # choose lexicon slots
    slot_mask = rng.random((n, cfg.seq_len)) < cfg.lexicon_rate
    match = rng.random((n, cfg.seq_len)) < cfg.class_purity
    lex_class = np.where(match, labels[:, None], 1 - labels[:, None])
    lex_tok = np.where(lex_class == 1,
                       rng.choice(pos_lex, size=(n, cfg.seq_len)),
                       rng.choice(neg_lex, size=(n, cfg.seq_len)))
    tokens = np.where(slot_mask, lex_tok.astype(np.int32), tokens)

    # variable lengths with right padding (tweets are short)
    lengths = rng.integers(8, cfg.seq_len + 1, size=n)
    pad = np.arange(cfg.seq_len)[None, :] >= lengths[:, None]
    tokens = np.where(pad, cfg.pad_id, tokens)
    return tokens, labels


def make_splits(n: int, seed: int = 0, train_frac: float = 0.9,
                cfg: SentimentConfig = SentimentConfig()):
    """Paper: 90% train / 10% test."""
    x, y = make_dataset(n, seed, cfg)
    k = int(n * train_frac)
    return (x[:k], y[:k]), (x[k:], y[k:])


def partition_users(x: np.ndarray, y: np.ndarray, n_users: int):
    """IID shards, one per federated user (paper: N=3)."""
    per = len(x) // n_users
    return [(x[i * per:(i + 1) * per], y[i * per:(i + 1) * per])
            for i in range(n_users)]


def partition_users_dirichlet(x: np.ndarray, y: np.ndarray, n_users: int,
                              alpha: float = 0.5, seed: int = 0):
    """Non-IID label partition (beyond-paper): each user's class mix is
    drawn from Dirichlet(alpha); alpha->0 gives single-class users,
    alpha->inf recovers IID (Hsu et al. 2019). Shards are truncated to a
    common length so every user's batches stay rectangular."""
    rng = np.random.default_rng(seed)
    classes = np.unique(y)
    user_idx = [[] for _ in range(n_users)]
    for c in classes:
        idx = np.flatnonzero(y == c)
        rng.shuffle(idx)
        props = rng.dirichlet(np.full(n_users, alpha))
        cuts = (np.cumsum(props) * len(idx)).astype(int)[:-1]
        for u, part in enumerate(np.split(idx, cuts)):
            user_idx[u].extend(part.tolist())
    per = min(len(ui) for ui in user_idx)
    shards = []
    for ui in user_idx:
        ui = np.asarray(ui[:per])
        rng.shuffle(ui)
        shards.append((x[ui], y[ui]))
    return shards
