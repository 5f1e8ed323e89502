"""Host-to-device staging at the junction's accept edge (port of
`siddhi_tpu/serving/staging.py`).

In the blocking path a batch's upload starts inside `process_staged`
(`StagedBatch.to_device`), after the junction has taken the query lock
and resolved group slots.  The stager moves the upload to the junction's
accept edge: the moment a staged batch enters dispatch (sync path) or the
`@async` ingress queue, its columns start copying on a side stream, and a
CUDA event marks the end of the copy.  `to_device` then adopts those
tensors, once, and the step's stream waits on the event.  The copies come
from pageable numpy memory, so the host stages each one before it goes
on; how much of a copy overlaps the previous batch's compute is not
measured.  Nothing bounds the uploads in flight: each belongs to a batch
the junction has already accepted.  On the CPU the stager stages nothing.
"""
from __future__ import annotations

import threading

import numpy as np
import torch


class DoubleBufferedStager:
    """Per-app staging: one side stream a device."""

    def __init__(self):
        self._lock = threading.Lock()
        self._streams = {}

    def stage(self, staged, schema, device: torch.device) -> None:
        """Start the upload of one StagedBatch on the side stream and
        attach it for `to_device` adoption.  Idempotent per batch."""
        from ..core.event import EventBatch, np_dtype
        if device.type != "cuda" or staged.dev is not None:
            return
        with self._lock:
            side = self._streams.get(device)
            if side is None:
                side = self._streams[device] = torch.cuda.Stream(device)
        main = torch.cuda.current_stream(device)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            def up(a):
                t = torch.from_numpy(np.ascontiguousarray(a)).to(
                    device, non_blocking=True)
                t.record_stream(main)
                return t
            batch = EventBatch(
                up(staged.ts), up(staged.kind), up(staged.valid),
                tuple(up(np.asarray(c, np_dtype(t)))
                      for c, t in zip(staged.cols, schema.types)))
            done = torch.cuda.Event()
            done.record(side)
        staged.dev = (schema, device, batch, done)
