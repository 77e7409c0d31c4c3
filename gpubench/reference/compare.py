"""The comparisons that decide ``correct``, run once the window has
closed, on the seeded sample of collected bursts.

- decode: each kept frame (components, H, W), read back from device
  memory, against the reference decode of the codestream it came from:
  the largest absolute difference of a sample (``max_abs_err``) and the
  share of samples that differ (``mismatch_share``).
- encode: each kept codestream against the reference encode of its
  frame: equal bytes agree; otherwise both are parsed by the reference
  decoder to their quantized subband samples (Tier-2 and Tier-1 only),
  and the share of samples that differ is counted
  (``coef_mismatch_share``); a codestream the reference cannot parse is
  ``unreadable``.
- both: ``frames_missing`` (frames a kept burst did not return) and
  ``failed`` (frames of bursts that raised).

Each number has its limit in the configuration file's ``limits``; the
run is correct when every number is at or under its limit.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from .htj2k import codec


def band_planes(stream: bytes) -> List[np.ndarray]:
    """The quantized subband samples of a one-tile codestream, band by
    band (component, resolution, band order): Tier-2 and Tier-1 of the
    reference decoder, dequantized for irreversible bands."""
    dec = codec.Decoder(stream)
    out = []
    for st in dec.tiles:
        for c, comp in enumerate(st.geom.comps):
            cod = dec.hdr.get_cod(c)
            rev = cod.is_reversible
            for r, res in enumerate(comp.resolutions):
                for b, sb in enumerate(res.bands):
                    if sb is None or sb.empty:
                        continue
                    out.append(dec._decode_band(
                        sb, st.coded[c][r][b], rev, cod.vert_causal,
                        np.int32 if rev else np.float32))
    return out


def decode_numbers(expected: Callable[[int], np.ndarray],
                   kept: Sequence[tuple]) -> dict:
    """``kept``: (slots, frames) of each kept burst, the frames as the
    program returned them; ``expected(slot)``: the reference's frame."""
    refs: Dict[int, np.ndarray] = {}
    worst, differ, total, missing = 0, 0, 0, 0
    for slots, frames in kept:
        missing += max(0, len(slots) - len(frames))
        for slot, got in zip(slots, frames):
            if slot not in refs:
                refs[slot] = expected(slot)
            ref = refs[slot]
            if got.shape != ref.shape:
                missing += 1
                continue
            d = np.abs(got.astype(np.int64) - ref)
            worst = max(worst, int(d.max()))
            differ += int(np.count_nonzero(d))
            total += d.size
    return {'max_abs_err': worst,
            'mismatch_share': differ / total if total else 1.0,
            'frames_missing': missing}


def _bands_or_none(stream: bytes, like: List[np.ndarray]):
    try:
        bands = band_planes(stream)
    except Exception:  # any failure to parse: not a readable codestream
        return None
    if len(bands) != len(like) or any(a.shape != b.shape
                                      for a, b in zip(bands, like)):
        return None
    return bands


def encode_numbers(expected: Callable[[int], bytes],
                   kept: Sequence[tuple]) -> dict:
    """``kept``: (slots, codestreams) of each kept burst;
    ``expected(slot)``: the reference's codestream of the frame."""
    refs: Dict[int, tuple] = {}      # slot -> (bytes, bands)
    seen: Dict[tuple, Optional[int]] = {}  # (slot, bytes) -> differ
    differ, total, unreadable, missing = 0, 0, 0, 0
    for slots, streams in kept:
        missing += max(0, len(slots) - len(streams))
        for slot, got in zip(slots, streams):
            if slot not in refs:
                ref = expected(slot)
                refs[slot] = (ref, band_planes(ref))
            ref, ref_bands = refs[slot]
            n = sum(b.size for b in ref_bands)
            if got != ref:
                key = (slot, bytes(got))
                if key not in seen:
                    bands = _bands_or_none(got, ref_bands)
                    seen[key] = None if bands is None else sum(
                        int(np.count_nonzero(a != b))
                        for a, b in zip(bands, ref_bands))
                if seen[key] is None:
                    unreadable += 1
                    continue
                differ += seen[key]
            total += n
    return {'coef_mismatch_share': differ / total if total else 1.0,
            'unreadable': unreadable, 'frames_missing': missing}


def check(direction: str, limits: dict, expected: Callable,
          kept: Sequence[tuple], failed: int) -> Dict[str, dict]:
    """{number: {'value', 'limit'}} of a run; ``expected(slot)`` is the
    reference's answer for a ring slot (a frame for decode, a
    codestream for encode), worked out only for the slots kept."""
    nums = (decode_numbers if direction == 'decode'
            else encode_numbers)(expected, kept)
    nums['failed'] = failed
    return {k: {'value': v, 'limit': limits[k]} for k, v in nums.items()}


def expected_fn(direction: str, config: dict, ring: list, codec_mod=None):
    """``expected(slot)`` of a cell: ``codec_mod`` (the reference codec,
    or the control) decoding the ring's codestreams or encoding its
    frames with the configuration's keywords."""
    from ..inputs.streams import encode_kwargs
    mod = codec_mod or codec
    if direction == 'decode':
        return lambda s: np.stack([p.astype(np.int64)
                                   for p in mod.decode(ring[s])])
    kw = encode_kwargs(config)
    return lambda s: mod.encode(ring[s], **kw)
