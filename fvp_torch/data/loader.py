"""Host-side batch pipeline: sample -> collate -> prefetch.

A copy of the reference package's `data/loader.py`: a thread-pool
prefetcher feeding fixed-shape numpy batches, in place of the original
implementation's DataLoader worker pool (run/train.py:68-73). The caller
copies each batch to its device. `seq_grouped_batches` is the reference
package's training order (its run/train.py:55-73): every batch drawn from
one sequence, so each train step sees one camera rig.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, Optional

import numpy as np

_pool: Optional[ThreadPoolExecutor] = None
_pool_size = 0
_pool_lock = threading.Lock()


def _get_pool(num_threads: int) -> ThreadPoolExecutor:
    """The shared pool of sample threads, grown (never shrunk) to the
    largest requested size — a later caller asking for more threads than
    the first is honored."""
    global _pool, _pool_size
    with _pool_lock:
        if _pool is None or num_threads > _pool_size:
            # the previous (smaller) pool is simply dropped: in-flight
            # work on it completes, interpreter exit joins it via the
            # executor's atexit hook
            _pool_size = max(num_threads, _pool_size)
            _pool = ThreadPoolExecutor(max_workers=_pool_size,
                                       thread_name_prefix="fvp-sample")
        return _pool


def build_samples(dataset, idxs, rng: Optional[np.random.RandomState],
                  num_threads: int = 4) -> list[dict]:
    """Build dataset samples in parallel on a shared thread pool (the
    reference's DataLoader worker analog, run/train.py:68-73; heatmap
    rendering is the host hot loop). Per-sample RNGs are seeded
    SEQUENTIALLY from `rng` so results are deterministic regardless of
    thread scheduling."""
    seeds = (rng.randint(0, 2 ** 31, size=len(idxs))
             if rng is not None else [None] * len(idxs))

    def build(args):
        i, seed = args
        sub = np.random.RandomState(seed) if seed is not None else None
        return dataset.sample(int(i), rng=sub)

    if num_threads <= 1 or len(idxs) <= 1:
        return [build(a) for a in zip(idxs, seeds)]
    return list(_get_pool(num_threads).map(build, zip(idxs, seeds)))


def collate(samples: list[dict]) -> dict:
    """Stack a list of sample dicts (one nesting level) into batch arrays."""
    out: dict = {}
    first = samples[0]
    for k, v in first.items():
        if isinstance(v, dict):
            out[k] = {kk: np.stack([s[k][kk] for s in samples])
                      for kk in v}
        else:
            out[k] = np.stack([s[k] for s in samples])
    return out


def batch_iterator(dataset, batch_size: int, shuffle: bool = False,
                   seed: int = 0, drop_last: bool = False,
                   epoch: int = 0, num_threads: int = 4) -> Iterator[dict]:
    """Batch iterator with per-epoch shuffling and thread-parallel sample
    building."""
    n = len(dataset)
    order = np.arange(n)
    rng = np.random.RandomState(seed + epoch)
    if shuffle:
        rng.shuffle(order)
    for start in range(0, n, batch_size):
        idx = order[start:start + batch_size]
        if drop_last and len(idx) < batch_size:
            return
        yield collate(build_samples(dataset, idx, rng, num_threads))


def seq_grouped_batches(dataset, batch_size: int, seed: int, epoch: int):
    """Yield (seq, batch) with every batch drawn from a single sequence:
    each sequence's records shuffled by the epoch's RNG and cut into full
    batches (the remainder dropped: fixed shapes), the chunks in a shuffled
    order, and each batch's samples built from the same RNG."""
    rng = np.random.RandomState(seed + epoch)
    by_seq: dict[str, list[int]] = {}
    for i, rec in enumerate(dataset.records):
        by_seq.setdefault(rec["seq"], []).append(i)
    chunks = []
    for seq, idxs in by_seq.items():
        idxs = np.asarray(idxs)
        rng.shuffle(idxs)
        for s in range(0, len(idxs), batch_size):
            chunk = idxs[s:s + batch_size]
            if len(chunk) == batch_size:
                chunks.append((seq, chunk))
    for ci in rng.permutation(len(chunks)):
        seq, idxs = chunks[ci]
        yield seq, collate(build_samples(dataset, idxs, rng))


def prefetch(it: Iterator[dict], depth: int = 2) -> Iterator[dict]:
    """Run the iterator in a background thread with a bounded queue
    (drop-nothing; training consumes every batch)."""
    q: queue.Queue = queue.Queue(maxsize=depth)
    sentinel = object()
    err: list[BaseException] = []

    def worker():
        try:
            for item in it:
                q.put(item)
        except BaseException as e:  # surfaced on the consumer side
            err.append(e)
        finally:
            q.put(sentinel)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    while True:
        item = q.get()
        if item is sentinel:
            if err:
                raise err[0]
            return
        yield item
