"""Samplers (port of `incubator_mxnet_tpu/gluon/data/sampler.py`, host
code kept as it is: `RandomSampler` draws `numpy.random.permutation` and
`ElasticSampler` a seeded `RandomState`, so under the same numpy seed an
epoch's order is the reference's, index for index)."""
from __future__ import annotations

import numpy as onp

__all__ = ["Sampler", "SequentialSampler", "RandomSampler", "BatchSampler",
           "FilterSampler", "ElasticSampler"]


class Sampler:
    def __iter__(self):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError


class SequentialSampler(Sampler):
    def __init__(self, length, start=0):
        self._length = length
        self._start = start

    def __iter__(self):
        return iter(range(self._start, self._start + self._length))

    def __len__(self):
        return self._length


class RandomSampler(Sampler):
    def __init__(self, length):
        self._length = length

    def __iter__(self):
        return iter(onp.random.permutation(self._length).tolist())

    def __len__(self):
        return self._length


class FilterSampler(Sampler):
    def __init__(self, fn, dataset):
        self._indices = [i for i in range(len(dataset)) if fn(dataset[i])]

    def __iter__(self):
        return iter(self._indices)

    def __len__(self):
        return len(self._indices)


class ElasticSampler(Sampler):
    """Rank-sharded sampler whose shard assignment can change MID-epoch.

    Every rank holds the same seeded epoch permutation and takes the
    interleaved stride ``perm[base + pos*num_shards + index]`` (the same
    striding as ``Dataset.shard``). When an elastic topology transition
    shrinks the fleet (`fault.elastic.ElasticController`), survivors call
    :meth:`reshard` at the drained step boundary: the CONSUMED prefix of
    the permutation is frozen and only the unconsumed remainder is
    re-strided across the new world — no sample is double-fed (the prefix
    never re-enters) and none is dropped (the remainder is covered
    exactly once by the new stride).

    The consumed-prefix arithmetic assumes lockstep SPMD consumption:
    every rank has drawn the same number of samples when the transition
    runs (true at a drained train-step boundary, which is the only place
    the controller reshards).
    """

    def __init__(self, length, num_shards=1, index=0, shuffle=False,
                 seed=0):
        if not 0 <= index < num_shards:
            raise ValueError(
                f"ElasticSampler: index {index} ∉ [0, {num_shards})")
        self._perm = (onp.random.RandomState(seed).permutation(length)
                      if shuffle else onp.arange(length)).tolist()
        self._num_shards = int(num_shards)
        self._index = int(index)
        self._base = 0          # global offset of the unconsumed remainder
        self._pos = 0           # samples THIS rank drew since last reshard

    def __iter__(self):
        while True:
            g = self._base + self._pos * self._num_shards + self._index
            if g >= len(self._perm):
                return
            self._pos += 1
            yield self._perm[g]

    def __len__(self):
        # what a fresh __iter__ will still yield for THIS rank
        total = len(self._perm) - self._base - self._index
        mine = -(-total // self._num_shards) if total > 0 else 0
        return max(0, mine - self._pos)

    def reshard(self, num_shards, index, consumed=None):
        """Re-partition the unconsumed remainder across a new world.
        Call at a drained step boundary (all ranks consumed equally).

        `consumed` is the re-admission path (the GROW direction of an
        elastic transition): a rank joining mid-epoch holds a FRESH
        sampler that drew nothing locally, so the frozen prefix cannot
        be derived from ``_pos`` — the survivors broadcast the
        fleet-wide consumed count (``length - survivor.remaining()``)
        and the rejoiner passes it here. Survivors leave it None."""
        if not 0 <= index < num_shards:
            raise ValueError(
                f"ElasticSampler.reshard: index {index} ∉ [0, {num_shards})")
        if consumed is None:
            consumed = min(len(self._perm) - self._base,
                           self._pos * self._num_shards)
            self._base += consumed
        else:
            self._base = min(len(self._perm), max(0, int(consumed)))
        self._num_shards = int(num_shards)
        self._index = int(index)
        self._pos = 0

    def remaining(self):
        """Unconsumed samples fleet-wide (the remainder reshard splits)."""
        return max(0, len(self._perm) - self._base
                   - self._pos * self._num_shards)


class BatchSampler(Sampler):
    def __init__(self, sampler, batch_size, last_batch="keep"):
        self._sampler = sampler
        self._batch_size = batch_size
        self._last_batch = last_batch
        self._prev = []

    def __iter__(self):
        batch, self._prev = self._prev, []
        for i in self._sampler:
            batch.append(i)
            if len(batch) == self._batch_size:
                yield batch
                batch = []
        if batch:
            if self._last_batch == "keep":
                yield batch
            elif self._last_batch == "discard":
                return
            elif self._last_batch == "rollover":
                self._prev = batch
            else:
                raise ValueError(f"last_batch must be keep/discard/rollover, "
                                 f"got {self._last_batch}")

    def __len__(self):
        if self._last_batch == "keep":
            return (len(self._sampler) + self._batch_size - 1) // self._batch_size
        if self._last_batch == "discard":
            return len(self._sampler) // self._batch_size
        return (len(self._sampler) + len(self._prev)) // self._batch_size
