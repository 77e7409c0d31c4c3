"""The system under test: the port's video coders, driven through their
public entries.  This is the only module of the benchmark that imports
openjph_tpu_torch."""
from __future__ import annotations

from typing import List

import numpy as np
import torch


class DecodeCoder:
    """``VideoDecoder(to_device=True)``: a burst's codestreams in host
    memory to its frames in device memory (staged uploads, raw
    readers: the defaults)."""

    def __init__(self, config: dict, device, streams: List[bytes]):
        from openjph_tpu_torch import VideoDecoder
        from ..reference.htj2k.core import geometry, markers
        self.device = torch.device(device)
        self.items = streams
        self.vd = VideoDecoder(to_device=True, device=self.device)
        # where each tile lies in the frame, from the reference's reading
        # of the ring's header (every stream of a ring has the same)
        siz = markers.read_main_header(streams[0]).siz
        self.size = (siz.ysiz - siz.yosiz, siz.xsiz - siz.xosiz)
        self.tile_rects = [(r.y0 - siz.yosiz, r.y1 - siz.yosiz,
                            r.x0 - siz.xosiz, r.x1 - siz.xosiz)
                           for r in geometry.build_tile_grid(siz)]

    def submit(self, slots) -> None:
        self.vd.submit([self.items[s] for s in slots])

    def collect(self, sync: bool):
        """The oldest burst's frames, on the device; with ``sync`` the
        caller's stream has finished them."""
        outs = self.vd.collect_on_device()
        if sync and self.device.type == 'cuda':
            torch.cuda.current_stream(self.device).synchronize()
        return outs

    def finish(self) -> None:
        """Check every pending error flag and wait for the device."""
        self.vd.drain_errors()
        if self.device.type == 'cuda':
            torch.cuda.synchronize(self.device)

    def to_host(self, outs) -> List[np.ndarray]:
        """A collected burst (``outs[tile][comp]``, each [F, h, w]) as
        host frames, each (components, H, W), its tiles put in place."""
        if len(outs) != len(self.tile_rects):
            raise ValueError(f'{len(outs)} tiles returned, the stream has '
                             f'{len(self.tile_rects)}')
        tiles = [[c.cpu().numpy() for c in t] for t in outs]
        n = min(c.shape[0] for t in tiles for c in t)
        frames = np.zeros((n, len(tiles[0])) + self.size,
                          np.result_type(*[c for t in tiles for c in t]))
        for (y0, y1, x0, x1), t in zip(self.tile_rects, tiles):
            for k, c in enumerate(t):
                frames[:, k, y0:y1, x0:x1] = c[:n]
        return list(frames)

    def close(self) -> None:
        self.vd.close()


class EncodeCoder:
    """``VideoEncoder``: a burst of frames in host memory to their
    codestreams in host memory."""

    def __init__(self, config: dict, device, frames: List[np.ndarray]):
        from openjph_tpu_torch import VideoEncoder
        from ..inputs.streams import encode_kwargs
        self.items = frames
        self.ve = VideoEncoder(device=device, **encode_kwargs(config))

    def submit(self, slots) -> None:
        self.ve.submit([self.items[s] for s in slots])

    def collect(self, sync: bool) -> List[bytes]:
        return self.ve.collect()

    def finish(self) -> None:
        pass

    def to_host(self, outs) -> List[bytes]:
        return list(outs)

    def close(self) -> None:
        self.ve.close()


CODERS = {'decode': DecodeCoder, 'encode': EncodeCoder}


def trace_module():
    """The port's stage timers (``openjph_tpu_torch.trace``)."""
    from openjph_tpu_torch import trace
    return trace
