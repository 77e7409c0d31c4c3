"""Host <-> device transfers of the video paths, overlapped with the
device's work: the PyTorch counterpart of the JAX package's
``jax.device_put`` staging and its device-to-host fetch workers.

A :class:`Stager` belongs to one device.  Its uploads copy host arrays
into pinned staging buffers, kept in a ring of ``slots`` per key (the
caller's plan key and burst size), and from there to the device with
``non_blocking`` copies on a side stream; a buffer is overwritten only
after the event of the copy that last read it.  The stream that reads
the uploaded tensors waits on that copy's event.  Its fetches copy
device tensors into pinned host memory on a fetch stream, after the
event of the work that wrote them, and block on the copies' event.

On the CPU an upload is a plain copy and a fetch a plain view.  On a
CUDA device, inside a traced video decode burst (``trace.burst_stage``),
the stages ``decode.upload.slot_wait`` (a host block on the copy that
last read a slot) and ``decode.staging_alloc`` (a pinned buffer
allocated: a ring that grew or was made anew, and every fetch's) time
the two host costs that a steady stream should not pay.
"""
from __future__ import annotations

import threading
from collections import OrderedDict

import numpy as np
import torch

from ..utils import trace


class _Slot:
    __slots__ = ('bufs', 'event', 'busy')

    def __init__(self):
        self.bufs = []      # pinned uint8 tensors, one per array
        self.event = None   # the event of the copies that last read them
        self.busy = False   # filled or copied from right now


class Stager:
    """Uploads through a ring of pinned buffers and fetches into pinned
    memory, for ``device``."""

    def __init__(self, device: torch.device, slots: int = 3,
                 keys: int = 8):
        self.device = device
        self.slots = slots
        self.keys = keys
        self._rings: 'OrderedDict' = OrderedDict()
        self._next: dict = {}
        self._lock = threading.Lock()
        if device.type == 'cuda':
            self.copy_stream = torch.cuda.Stream(device)
            self.fetch_stream = torch.cuda.Stream(device)

    def _acquire(self, key) -> _Slot:
        """The ring's next free slot for ``key``: its last copies may
        still run (the caller waits on its event); a ring whose every
        slot is being filled grows by one."""
        with self._lock:
            ring = self._rings.get(key)
            if ring is None:
                ring = self._rings[key] = [_Slot() for _ in
                                           range(self.slots)]
                self._next[key] = 0
                while len(self._rings) > self.keys:
                    old, _ = self._rings.popitem(last=False)
                    del self._next[old]
            self._rings.move_to_end(key)
            at = self._next[key]
            for k in range(len(ring)):
                slot = ring[(at + k) % len(ring)]
                if not slot.busy:
                    self._next[key] = (at + k + 1) % len(ring)
                    break
            else:
                slot = _Slot()
                ring.append(slot)
            slot.busy = True
            return slot

    def upload(self, key, arrays, stream=None) -> tuple:
        """The numpy ``arrays`` as tensors on the device, ready for
        ``stream`` (a CUDA stream that reads them: it waits on their
        copies, and the tensors are recorded on it)."""
        if self.device.type != 'cuda':
            return tuple(torch.from_numpy(np.array(a, copy=True))
                         for a in arrays)
        slot = self._acquire(key)
        try:
            if slot.event is not None:
                with trace.burst_stage('decode.upload.slot_wait'):
                    slot.event.synchronize()
            outs = []
            with torch.cuda.stream(self.copy_stream):
                for i, a in enumerate(arrays):
                    a = np.ascontiguousarray(a)
                    n = a.nbytes
                    if i == len(slot.bufs):
                        slot.bufs.append(None)
                    if slot.bufs[i] is None or slot.bufs[i].numel() < n:
                        with trace.burst_stage('decode.staging_alloc'):
                            slot.bufs[i] = torch.empty(max(n, 1),
                                                       dtype=torch.uint8,
                                                       pin_memory=True)
                    host = slot.bufs[i][:n]
                    host.numpy()[:] = a.reshape(-1).view(np.uint8)
                    dev = torch.empty(n, dtype=torch.uint8,
                                      device=self.device)
                    dev.copy_(host, non_blocking=True)
                    outs.append(dev.view(torch.from_numpy(a[:0]).dtype)
                                .reshape(a.shape))
                ev = torch.cuda.Event()
                ev.record(self.copy_stream)
            slot.event = ev
        finally:
            with self._lock:
                slot.busy = False
        if stream is not None:
            stream.wait_event(ev)
            for t in outs:
                t.record_stream(stream)
        return tuple(outs)

    def fetch(self, tensors, after=None) -> list:
        """``tensors`` as numpy arrays in host memory, copied after the
        CUDA event ``after`` (the work that wrote them); blocks until
        the copies are done."""
        if self.device.type != 'cuda':
            return [t.numpy() for t in tensors]
        s = self.fetch_stream
        hosts = []
        with torch.cuda.stream(s):
            if after is not None:
                s.wait_event(after)
            for t in tensors:
                with trace.burst_stage('decode.staging_alloc'):
                    h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                h.copy_(t, non_blocking=True)
                t.record_stream(s)
                hosts.append(h)
            ev = torch.cuda.Event()
            ev.record(s)
        ev.synchronize()
        return [h.numpy() for h in hosts]
