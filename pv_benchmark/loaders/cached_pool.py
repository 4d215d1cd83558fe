"""A pool of distinct host batches drawn from the seed at set-up, handed to
the program in turn: what a loader that holds its batches on the host
delivers. The traffic mix sets the pool's size (``pool_batches``)."""

from __future__ import annotations

import time
from typing import Iterator, List, Optional

from pv_benchmark import feed


class Feed:
    """The loader handed to the program: batches from the pool in turn from
    ``start``, ``count`` of them or, while ``deadline`` (host clock) is set,
    as long as the clock has not passed it when the program asks. The
    deadline may be set while the program iterates."""

    def __init__(self, pool: List[dict], start: int = 0, count: Optional[int] = None,
                 deadline: Optional[float] = None):
        self.pool, self.start, self.count, self.deadline = pool, start, count, deadline
        self.served = 0

    def __iter__(self) -> Iterator[dict]:
        return self

    def __next__(self) -> dict:
        if self.count is not None and self.served >= self.count:
            raise StopIteration
        if self.deadline is not None and time.perf_counter() >= self.deadline:
            raise StopIteration
        item = self.pool[(self.start + self.served) % len(self.pool)]
        self.served += 1
        return item


class Source:
    def __init__(self, batches: List[dict]):
        self.batches = batches

    def __len__(self) -> int:
        return len(self.batches)

    def batch(self, i: int) -> dict:
        """The host batch that item ``i`` of a loader started at 0 is."""
        return self.batches[i % len(self.batches)]

    def loader(self, start: int = 0, count: Optional[int] = None, deadline: Optional[float] = None) -> Feed:
        return Feed(self.batches, start=start, count=count, deadline=deadline)


def open_source(cell, seed: int, device) -> Source:
    """The cell's pool, drawn on ``device`` from ``seed`` and brought to the host."""
    return Source(feed.make_pool(cell.config["fields"], cell.traffic["pool_batches"], seed, device))
