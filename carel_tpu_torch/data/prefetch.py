"""Background host-to-device batch prefetching, port of
carel_tpu/data/prefetch.py.

The reference's DataLoader runs with num_workers=0 (flagship :955): every
batch is built synchronously between steps. Here a daemon thread stays
``size`` batches ahead: it cuts the batch (``transform``), pins its arrays
and copies them to the card on a stream of its own, overlapping both with
the step the main thread is running.
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Callable, Iterator, Optional

import numpy as np
import torch

_SENTINEL = object()


def _map(fn: Callable, item: Any) -> Any:
    """``fn`` on an array, or on every array of a dict of them."""
    if isinstance(item, dict):
        return {k: fn(v) for k, v in item.items()}
    return fn(item)


def _leaves(item: Any):
    return item.values() if isinstance(item, dict) else (item,)


def prefetch_to_device(
    iterator: Iterator[Any],
    size: int = 2,
    transform: Optional[Callable[[Any], Any]] = None,
    device="cpu",
) -> Iterator[Any]:
    """Yield the items of ``iterator`` (after ``transform``, e.g. Batch ->
    dict: an array, numpy or torch, or a dict of them) with every array on
    ``device``, prepared on a background thread ``size`` items ahead.

    On CUDA the worker copies from pinned memory on its own stream and waits
    for the copy to finish before it hands the item over, so no item is read
    before its copy has finished and no pinned buffer is dropped while a copy
    reads it; each tensor is then marked as used on the consumer's stream,
    so the allocator does not hand its memory to the copy stream while a
    step still reads it. A worker's exception is raised in the consumer
    after the items before it."""
    device = torch.device(device)
    cuda = device.type == "cuda"
    copy_stream = torch.cuda.Stream(device) if cuda else None
    q: queue.Queue = queue.Queue(maxsize=size)
    err: list = []

    def to_device(leaf):
        t = torch.from_numpy(np.ascontiguousarray(leaf)) \
            if isinstance(leaf, np.ndarray) else leaf
        if not cuda:
            return t.to(device)
        return t.pin_memory().to(device, non_blocking=True)

    def worker():
        try:
            for item in iterator:
                if transform is not None:
                    item = transform(item)
                if cuda:
                    with torch.cuda.stream(copy_stream):
                        item = _map(to_device, item)
                        done = torch.cuda.Event()
                        done.record(copy_stream)
                    done.synchronize()
                else:
                    item = _map(to_device, item)
                q.put(item)
        except Exception as e:  # surfaced in the consumer thread
            err.append(e)
        finally:
            q.put(_SENTINEL)

    threading.Thread(target=worker, daemon=True).start()
    while True:
        item = q.get()
        if item is _SENTINEL:
            break
        if cuda:
            consumer = torch.cuda.current_stream(device)
            for leaf in _leaves(item):
                leaf.record_stream(consumer)
        yield item
    if err:
        raise err[0]
