from repro_torch.data.pipeline import (batches, synthetic_corpus,
                                       synthetic_lm_batches)
from repro_torch.data.sentiment import (SentimentConfig, make_dataset,
                                        make_splits, partition_users,
                                        partition_users_dirichlet)

__all__ = ["batches", "synthetic_corpus", "synthetic_lm_batches",
           "SentimentConfig", "make_dataset", "make_splits",
           "partition_users", "partition_users_dirichlet"]
