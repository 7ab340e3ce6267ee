from repro_torch.data.pipeline import (
    EpisodeTokenizer,
    TokenBatchIterator,
    episode_dataset,
    synthetic_lm_batches,
)

__all__ = [
    "EpisodeTokenizer",
    "TokenBatchIterator",
    "episode_dataset",
    "synthetic_lm_batches",
]
