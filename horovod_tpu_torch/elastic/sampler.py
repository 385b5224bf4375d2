"""ElasticSampler: rescale-aware dataset sharding (the port's copy of
``horovod_tpu/elastic/sampler.py``: the same seeded order, so both
packages hand a rank the same indices).

Reference: ``horovod/torch/elastic/sampler.py`` -- shard sample indices
over ranks; record processed indices; on rescale, reshard only the
*remaining* indices so no sample is dropped or repeated within an epoch.
"""

from __future__ import annotations

import random
from typing import Iterator, List, Optional, Sequence


class ElasticSampler:
    def __init__(self, num_samples: int, shuffle: bool = True, seed: int = 0):
        self.num_samples = num_samples
        self.shuffle = shuffle
        self.seed = seed
        self.epoch = 0
        self.processed: set = set()
        self.rank = 0
        self.size = 1
        self._reset_order()

    def _reset_order(self) -> None:
        order = list(range(self.num_samples))
        if self.shuffle:
            random.Random(self.seed + self.epoch).shuffle(order)
        self._order = order

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch
        self.processed.clear()
        self._reset_order()

    def set_rank_and_size(self, rank: int, size: int) -> None:
        """Call after (re-)rendezvous; remaining samples are resharded."""
        self.rank = rank
        self.size = size

    def record_batch(self, indices: Sequence[int]) -> None:
        self.processed.update(int(i) for i in indices)

    def state_dict(self) -> dict:
        return {"epoch": self.epoch, "processed": sorted(self.processed)}

    def load_state_dict(self, state: dict) -> None:
        self.epoch = state["epoch"]
        self._reset_order()
        self.processed = set(state["processed"])

    @property
    def remaining(self) -> List[int]:
        return [i for i in self._order if i not in self.processed]

    def __len__(self) -> int:
        rem = len(self.remaining)
        return (rem + self.size - 1 - self.rank) // self.size

    def __iter__(self) -> Iterator[int]:
        rem = self.remaining
        # Rank-strided shard of the remaining indices.
        return iter(rem[self.rank::self.size])
