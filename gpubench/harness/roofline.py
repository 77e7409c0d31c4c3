"""The yardstick of the kernels' roofline shares: the card's peak, and
the bytes that a Tier-1 kernel must move for a frame, counted from the
workload (the codestream and its geometry, parsed by the reference's
frozen Tier-2), never from the port's padded lanes or word buckets.
Each input byte is counted once and each output byte once:

- K2 (HT cleanup decode): the cleanup segments' bytes read, plus 4
  bytes written for each sample of a codeblock that has a segment;
- K3 (HT cleanup encode): 4 bytes read for each codeblock sample, plus
  the cleanup segments' bytes written.

Neither kernel's arithmetic comes near the card's compute peaks (a few
operations a sample), so bytes bound both.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Tuple

from ..reference.htj2k import codec

# NVIDIA H100 SXM data sheet: 80 GB of HBM3 at 3.35 TB/s, at the full
# power limit of 700 W (the result line gives the card's limit beside
# each share)
PEAK_HBM_BYTES_S = 3.35e12


def cleanup_blocks(stream: bytes) -> List[Tuple[int, int, int]]:
    """(width, height, cleanup segment bytes) of every codeblock of the
    codestream; 0 bytes for a block with no segment."""
    dec = codec.Decoder(stream)
    out = []
    for st in dec.tiles:
        for c, comp in enumerate(st.geom.comps):
            for r, res in enumerate(comp.resolutions):
                for b, sb in enumerate(res.bands):
                    if sb is None or sb.empty:
                        continue
                    coded = st.coded[c][r][b]
                    for g in sb.blocks:
                        cb = coded[g.cb_y * sb.num_cb_x + g.cb_x]
                        n = 0
                        if cb is not None and cb.data and cb.num_passes:
                            n = int(cb.pass_length[0])
                        out.append((g.rect.w, g.rect.h, n))
    return out


def k2_bytes(stream: bytes) -> int:
    return sum(n + 4 * w * h for w, h, n in cleanup_blocks(stream) if n)


def k3_bytes(stream: bytes) -> int:
    return sum(4 * w * h + n for w, h, n in cleanup_blocks(stream))


def least_seconds(nbytes: float) -> float:
    return nbytes / PEAK_HBM_BYTES_S


class Workload:
    """The bytes of a cell's ring, per frame on average: ``stream(slot)``
    gives the codestream of a ring slot (the input for decode, the
    reference's encode for encode)."""

    def __init__(self, stream: Callable[[int], bytes], ring: int):
        self.stream, self.ring = stream, ring
        self._mean: Dict[str, float] = {}

    def _per_frame(self, fn) -> float:
        if fn.__name__ not in self._mean:
            self._mean[fn.__name__] = sum(
                fn(self.stream(s)) for s in range(self.ring)) / self.ring
        return self._mean[fn.__name__]

    def k2_bytes_per_frame(self) -> float:
        return self._per_frame(k2_bytes)

    def k3_bytes_per_frame(self) -> float:
        return self._per_frame(k3_bytes)
