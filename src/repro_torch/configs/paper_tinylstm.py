"""The paper's own 89,673-parameter model (Sec. III-A): Embedding(8) ->
Conv1D(32,k3) -> MaxPool(2) -> LSTM(32) -> Dense(16) -> Dense(1).
vocab = 10,001 (10k most-frequent + OOV/pad), seq_len 30."""
import torch

from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="paper-tinylstm",
    family="tiny",
    citation="this paper, Sec. III-A (Sentiment140 sentiment classifier)",
    n_layers=1,
    d_model=32,
    n_heads=1,
    n_kv_heads=1,
    d_ff=16,
    vocab_size=10_001,
    rope_theta=0.0,
    dtype=torch.float32,
    remat=False,
))
