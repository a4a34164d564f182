"""Device prefetch: upload batch t+1 while the step of batch t runs.

The port's counterpart of cliora_tpu/data/prefetch.py (``device_put``
ahead of the step).  On the card each host batch's device arrays are
written once into pinned (page-locked) host buffers, with their dtype
conversion, and copied ``non_blocking`` on a side stream.  The consumer's
stream waits on an event recorded after the copies, and every uploaded
tensor is ``record_stream``-ed on that stream, so the caching allocator
does not hand its memory out again while a step still reads it.  The
yielded batch holds the tensors ``Trainer._place_batch`` takes as they
are (its dtypes, on its device): neither ``Trainer.step`` nor the
replayed graph of ``Trainer.steps`` makes a second host copy or a
pageable one.  (The pinned buffers come from PyTorch's caching host
allocator, which keeps a buffer from reuse until the copy that read it
has finished.)

The batch iterator's producer thread (data/batching.py) builds numpy
batch maps only; this module, in the consumer's thread, is the only one
that touches CUDA.  Staging one batch (the pinned allocations, the numpy
copies and the enqueue of its uploads) is the tracing registry's span
``prefetch.stage``.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np
import torch

from cliora_tpu_torch.utils import observability as obs

# the batch map's device arrays and the dtypes Trainer._place_batch gives
# them
DEVICE_KEYS = {
    "sentences": torch.int64,
    "neg_samples": torch.int64,
    "obj_feats": torch.float32,
    "lengths": torch.int64,
}


class _Uploader:
    """Pinned staging + ``non_blocking`` copies on one side stream."""

    def __init__(self, device: torch.device):
        self.device = device
        self.stream = torch.cuda.Stream(device)

    def put(self, batch_map):
        out = dict(batch_map)
        with obs.span("prefetch.stage"), torch.cuda.stream(self.stream):
            for key, dtype in DEVICE_KEYS.items():
                value = batch_map.get(key)
                if value is None or isinstance(value, torch.Tensor):
                    continue
                value = np.asarray(value)
                pinned = torch.empty(value.shape, dtype=dtype,
                                     pin_memory=True)
                pinned.numpy()[...] = value
                out[key] = pinned.to(self.device, non_blocking=True)
            ready = torch.cuda.Event()
            ready.record(self.stream)
        return out, ready

    def take(self, batch_map, ready):
        """Order the device's current stream after the batch's copies."""
        current = torch.cuda.current_stream(self.device)
        current.wait_event(ready)
        for key in DEVICE_KEYS:
            value = batch_map.get(key)
            if isinstance(value, torch.Tensor) and value.is_cuda:
                value.record_stream(current)
        return batch_map


def device_prefetch(iterator: Iterator[dict], device,
                    lookahead: int = 2) -> Iterator[dict]:
    """Yield the batch maps of ``iterator`` with their device arrays
    already uploaded to ``device`` (a dp rank's own card),
    ``lookahead`` batches ahead of the consumer.  On a CPU device the batch maps pass through unchanged
    (``Trainer._place_batch`` reads the numpy arrays directly)."""
    device = torch.device(device)
    if device.type != "cuda":
        yield from iterator
        return
    uploader = _Uploader(device)
    buf = []
    for batch_map in iterator:
        buf.append(uploader.put(batch_map))
        if len(buf) > lookahead:
            yield uploader.take(*buf.pop(0))
    for item in buf:
        yield uploader.take(*item)
