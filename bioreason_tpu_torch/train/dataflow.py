"""Host-side input pipeline: shuffled epoch batching over in-memory items, a
background prefetch and GRPO's repeat sampler (the port's copy of
bioreason_tpu/train/dataflow.py)."""

from __future__ import annotations

import queue
import random
import threading
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence


def batch_iterator(items: Sequence[Any], collate_fn: Callable[[List[Any]], Dict],
                   batch_size: int, shuffle: bool = True, seed: int = 0,
                   drop_last: bool = True, epochs: Optional[int] = 1) -> Iterator[Dict]:
    """Collated batches over `epochs` passes (None: forever), each pass in
    the order of random.Random(seed + epoch); a short last batch is dropped
    or, with drop_last=False, filled by wrapping around."""
    epoch = 0
    while epochs is None or epoch < epochs:
        order = list(range(len(items)))
        if shuffle:
            random.Random(seed + epoch).shuffle(order)
        for start in range(0, len(order), batch_size):
            chunk = order[start:start + batch_size]
            if len(chunk) < batch_size:
                if drop_last:
                    break
                chunk = (chunk * batch_size)[:batch_size]
            yield collate_fn([items[i] for i in chunk])
        epoch += 1


def prefetch(it: Iterator[Any], depth: int = 2) -> Iterator[Any]:
    """Run `it` in a background thread with a bounded buffer, so collation
    overlaps the device step. Exceptions re-raise at the consumer; closing
    the generator early stops the producer thread."""
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    sentinel = object()
    errs: List[BaseException] = []
    stop = threading.Event()

    def put(x) -> bool:
        while not stop.is_set():
            try:
                q.put(x, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            for x in it:
                if not put(x):
                    return
        except BaseException as e:          # propagate to the consumer
            errs.append(e)
        finally:
            put(sentinel)

    threading.Thread(target=worker, daemon=True).start()
    try:
        while True:
            x = q.get()
            if x is sentinel:
                if errs:
                    raise errs[0]
                return
            yield x
    finally:
        stop.set()
        while True:                          # unblock a producer mid-put
            try:
                q.get_nowait()
            except queue.Empty:
                break


def repeat_random_indices(n_items: int, batch_prompts: int, num_generations: int,
                          seed: int, epoch: int) -> Iterator[List[int]]:
    """Per-step index lists in which each prompt index appears
    `num_generations` times contiguously (RepeatRandomSampler semantics), in
    the order of random.Random(seed + epoch); a short last step is dropped."""
    order = list(range(n_items))
    random.Random(seed + epoch).shuffle(order)
    for start in range(0, len(order) - batch_prompts + 1, batch_prompts):
        prompts = order[start:start + batch_prompts]
        yield [i for i in prompts for _ in range(num_generations)]
