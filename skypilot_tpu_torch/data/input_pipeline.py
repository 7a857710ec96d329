"""Training input pipeline: sequence packing and a prefetch thread.

The port's own copy of ``skypilot_tpu/data/input_pipeline.py`` (it
imports nothing of the JAX package). Tokenized documents are packed
into fixed ``[batch, seq]`` buffers with *segment ids* (1-based per
document, 0 = padding) and *restart positions* (rope positions reset
per document), so packed documents cannot attend across boundaries
(the flash kernels mask on segment ids).

Packing is the JAX package's numpy version; its native C++ packer is
not copied. :func:`prefetch` moves batches to the device from a
background thread, and that thread ends when the consumer stops.
"""

from __future__ import annotations

import queue
import threading
from typing import Dict, Iterable, Iterator, List, Sequence

import numpy as np
import torch

from skypilot_tpu_torch import DeviceLike, resolve_device

# Batches :func:`prefetch` moves to the device ahead of the consumer.
PREFETCH_DEPTH = 2


def _pack_numpy(docs: List[np.ndarray], rows: int, cols: int,
                pad_id: int):
    tokens = np.full((rows, cols), pad_id, np.int32)
    segments = np.zeros((rows, cols), np.int32)
    positions = np.zeros((rows, cols), np.int32)
    used = [0] * rows
    next_seg = [1] * rows
    placed = 0
    for doc in docs:
        n = len(doc)
        if n > cols:
            placed += 1        # consumed (caller should pre-chunk)
            continue
        row = next((r for r in range(rows) if cols - used[r] >= n), -1)
        if row < 0:
            break
        tokens[row, used[row]:used[row] + n] = doc
        segments[row, used[row]:used[row] + n] = next_seg[row]
        positions[row, used[row]:used[row] + n] = np.arange(n)
        next_seg[row] += 1
        used[row] += n
        placed += 1
    return tokens, segments, positions, placed


def pack(docs: Sequence[Sequence[int]], rows: int, cols: int,
         pad_id: int = 0):
    """Pack documents -> (tokens, segment_ids, positions, n_placed).

    ``n_placed`` counts consumed documents; the caller carries
    ``docs[n_placed:]`` into the next batch.
    """
    return _pack_numpy([np.asarray(d, np.int32) for d in docs], rows, cols,
                       pad_id)


def packed_batches(doc_stream: Iterable[Sequence[int]], batch: int,
                   seq: int, pad_id: int = 0
                   ) -> Iterator[Dict[str, np.ndarray]]:
    """Stream documents -> packed train batches.

    Yields {"tokens", "segment_ids", "positions", "mask"} with
    mask = (segment_ids > 0) as the loss mask.
    """
    pending: List[Sequence[int]] = []
    it = iter(doc_stream)
    exhausted = False
    while not exhausted or pending:
        # Greedy fill: pull enough docs to plausibly fill the buffer.
        budget = batch * seq
        have = sum(min(len(d), seq) for d in pending)
        while not exhausted and have < budget * 2:
            try:
                d = next(it)
            except StopIteration:
                exhausted = True
                break
            if len(d) > seq:   # chunk oversized docs
                for i in range(0, len(d), seq):
                    pending.append(d[i:i + seq])
                    have += len(d[i:i + seq])
            else:
                pending.append(d)
                have += len(d)
        if not pending:
            break
        tokens, segments, positions, placed = pack(pending, batch, seq,
                                                   pad_id)
        if placed == 0:
            break
        pending = pending[placed:]
        yield {
            "tokens": tokens,
            "segment_ids": segments,
            "positions": positions,
            "mask": (segments > 0).astype(np.float32),
        }


def to_device(batch: Dict[str, np.ndarray],
              device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    """numpy batch -> tensors on ``device`` (dtypes kept: int32 ids and
    positions, float32 mask)."""
    device = resolve_device(device)
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in batch.items()}


def prefetch(batches: Iterable[Dict[str, np.ndarray]],
             device: DeviceLike = None) -> Iterator[Dict[str, torch.Tensor]]:
    """Batches moved to ``device`` by a background thread, up to
    ``PREFETCH_DEPTH`` ahead. The thread ends when the stream ends, and
    also when the consumer stops: closing this generator (``close()``,
    or dropping it) stops and joins the thread, even over an infinite
    stream."""
    device = resolve_device(device)
    q: "queue.Queue" = queue.Queue(maxsize=PREFETCH_DEPTH)
    stop = threading.Event()
    end = object()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.05)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            for b in batches:
                if not put(to_device(b, device)):
                    return
            put(end)
        except Exception as e:  # noqa: BLE001 — re-raised in the consumer
            put(e)

    t = threading.Thread(target=worker, name="prefetch", daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is end:
                return
            if isinstance(item, Exception):
                raise item
            yield item
    finally:
        stop.set()
        t.join(timeout=30)


def synthetic_doc_stream(n_docs: int, vocab_size: int, mean_len: int,
                         seed: int = 0) -> Iterator[List[int]]:
    """Length-varied synthetic documents (for benchmarks/tests)."""
    rng = np.random.default_rng(seed)
    for _ in range(n_docs):
        n = max(int(rng.poisson(mean_len)), 1)
        yield rng.integers(1, vocab_size, n).astype(np.int32).tolist()
