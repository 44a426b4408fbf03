from repro_torch.data.sentiment import (SentimentConfig, make_dataset,
                                        make_splits, partition_users,
                                        partition_users_dirichlet)

__all__ = ["SentimentConfig", "make_dataset", "make_splits",
           "partition_users", "partition_users_dirichlet"]
