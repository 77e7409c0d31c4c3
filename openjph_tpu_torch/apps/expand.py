"""ojph_expand-compatible decoder CLI on the GPU.

Flags mirror OpenJPH's src/apps/ojph_expand/ojph_expand.cpp, as the JAX
package's openjph_tpu/apps/expand.py does: -i -o -skip_res <x[,y]>
-resilient.  Output format from the -o extension
(.pgm/.ppm/.pfm/.yuv/.raw/.rawl/.tif).  The decode runs on the card
(GpuDecoder), with no host fallback: without a card, or for a stream the
port does not decode yet, the run fails with the error's message and
writes no output file.
"""
from __future__ import annotations

import os
import sys
import time

import numpy as np

from ..gpu.pipeline import GpuDecoder
from ..utils import imageio
from .cli import ArgError, Args

USAGE = """ojph-gpu-expand -i input.j2c -o output [options]
 -skip_res <x[,y]>   skip x resolutions on parse[, y on reconstruction]
 -resilient <bool>   tolerate corrupted streams
"""


def main(argv=None, device='cuda') -> int:
    """Run the CLI on ``argv`` (default: the command line); the decode
    runs on ``device`` (the card from the command line; Python callers
    may pass 'cpu' for the kernels' plain versions).  Returns the exit
    code."""
    argv = sys.argv[1:] if argv is None else argv
    if not argv or argv[0] in ('-h', '--help'):
        print(USAGE)
        return 0
    try:
        args = Args(argv)
        src = args.get('-i')
        out = args.get('-o')
        if src is None or out is None:
            raise ArgError('-i and -o are required')
        skip = args.get_int_list('-skip_res') or [0]
        resilient = args.get_bool('-resilient', False)
        args.check_unused()

        data = open(src, 'rb').read()
        t0 = time.time()
        skip_read = skip[0]
        skip_recon = skip[1] if len(skip) > 1 else skip[0]
        dec = GpuDecoder(data, device=device, resilient=resilient,
                         skipped_res_for_read=skip_read,
                         skipped_res_for_recon=skip_recon)
        planes = dec.decode()
        elapsed = time.time() - t0

        siz = dec.hdr.siz
        bd = max(siz.comps[c].bit_depth for c in range(siz.num_comps))
        ext = os.path.splitext(out)[1].lower()
        if ext in ('.pgm', '.ppm'):
            maxval = (1 << bd) - 1
            dtype = np.uint8 if bd <= 8 else np.uint16
            clipped = [np.clip(p, 0, maxval).astype(dtype)
                       for p in planes]
            if ext == '.ppm':
                if len(clipped) < 3:
                    raise ArgError('.ppm needs 3 components')
                img = np.stack(clipped[:3], axis=-1)
            else:
                if len(clipped) != 1:
                    raise ArgError('.pgm needs a single component')
                img = clipped[0]
            imageio.write_pnm(out, img, maxval=maxval)
        elif ext == '.yuv':
            imageio.write_yuv(out, planes, bd)
        elif ext in ('.raw', '.rawl'):
            sgn = siz.comps[0].is_signed
            imageio.write_raw(out, planes[0], bd, sgn)
        elif ext in ('.tif', '.tiff'):
            dtype = np.uint8 if bd <= 8 else np.uint16
            maxval = (1 << bd) - 1
            clipped = [np.clip(p, 0, maxval).astype(dtype)
                       for p in planes]
            img = np.stack(clipped, axis=-1) if len(clipped) > 1 \
                else clipped[0]
            imageio.write_tiff(out, img)
        elif ext == '.pfm':
            img = np.stack(planes, axis=-1).astype(np.float32) \
                if len(planes) > 1 else planes[0].astype(np.float32)
            imageio.write_pfm(out, img)
        else:
            raise ArgError(f'unsupported output extension {ext}')
        print(f'Elapsed time = {elapsed:f}')
        return 0
    # RuntimeError: no card
    except (ArgError, ValueError, OSError, EOFError, RuntimeError) as e:
        print(f'ojph-gpu-expand: {e}', file=sys.stderr)
        return 1


if __name__ == '__main__':
    sys.exit(main())
