"""openjph_tpu_torch: the HTJ2K (ISO/IEC 15444-15) codec of openjph_tpu,
ported to PyTorch and CUDA for one NVIDIA H100.

The host layer (codestream syntax, Tier-2, planning, packing, byte
stuffing) is a copy of the JAX package's; the device paths are torch
ops plus hand-written CUDA kernels for the HT cleanup-pass decode and
encode and for the refinement passes (SigProp / MagRef) of multi-pass
codeblocks, both ways: the decode refines them, and the encode takes
``ht_passes`` 2 and 3 through the cleanup encoder and the refinement-pass
encoder.

Decode takes damaged streams as the JAX package does: strict mode
(the default) raises ValueError / EOFError, and ``resilient=True``
returns full-size frames with broken codeblocks zeroed.  Encode takes
Part-2 decomposition structures (``GpuEncoder(..., dfs_list=...)``) and
arbitrary wavelet kernels (``atks=``).  Entry points run on the card
(``device='cuda'``) unless the caller passes ``device='cpu'``, which
runs the kernels' plain PyTorch versions; a CUDA request without a card
raises RuntimeError.

Video: ``VideoDecoder`` / ``decode_gpu_batch`` and ``VideoEncoder`` /
``encode_gpu_batch`` batch frames of one geometry into bursts, one
device dispatch each, with host preparation, uploads and fetches on
worker threads beside the card's work.

``trace`` times the pipelines' stages under the JAX package's stage
names, with each stage's parent and self time, follows each video
decode burst from submit to collect (its waits, its dispatch's upload,
Tier-1 and rest of graph, the runner and staging misses, and which
stages the slowest 5% of bursts spent), records the collector's pauses,
and profiles the card (``trace.torch_trace``); ``apps`` holds the
command-line coders (``python -m openjph_tpu_torch.apps.compress``,
``.expand``, ``.stream_expand``), which run on the card.

Scale-out lives in ``openjph_tpu_torch.parallel``, as in the JAX
package, and is not loaded by this import: ``MosaicDecoder`` /
``decode_mosaic`` and ``MosaicEncoder`` / ``encode_mosaic`` batch a
multi-tile image's tiles on the fused runners over a device mesh
(``make_mesh``), in sub-batches that bound memory, streaming tile-parts
to a file and decoding from an ``mmap``; ``parallel.dwt_sharded`` lifts
row-sharded planes with halo rows over ``torch.distributed``;
``parallel.multihost`` spreads bursts of frames over processes.
"""
from .core.message import (  # noqa: F401
    OjphError, OjphWarning, set_info_stream, set_warning_stream,
    set_error_stream, configure_info, configure_warning,
    configure_error, set_message_level)
from .gpu.encode_pipeline import (GpuEncoder, VideoEncoder,  # noqa: F401
                                  encode_gpu, encode_gpu_batch)
from .gpu.pipeline import (GpuDecoder, VideoDecoder,  # noqa: F401
                           decode_gpu, decode_gpu_batch)
from .utils import trace  # noqa: F401


def decode(data: bytes, device='cuda', skip_res: int = 0,
           resilient: bool = False, raw: bool = True):
    """Decode a .j2c codestream, multi-pass codeblocks included, to
    per-component numpy planes on ``device``; ``resilient=True`` decodes
    damaged streams, zeroing broken codeblocks (see :func:`decode_gpu`)."""
    return decode_gpu(data, device=device, skip_res=skip_res,
                      resilient=resilient, raw=raw)


def encode(planes, device='cuda', **kwargs) -> bytes:
    """Encode per-component planes into a .j2c codestream on ``device``
    (see :func:`encode_gpu`); the keywords are openjph_tpu.encode's."""
    return encode_gpu(planes, device=device, **kwargs)


__version__ = '0.1.0'
