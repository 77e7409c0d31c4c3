"""ojph_compress-compatible encoder CLI on the GPU.

Flag dialect and semantics mirror OpenJPH's
src/apps/ojph_compress/ojph_compress.cpp:531-628, as the JAX package's
openjph_tpu/apps/compress.py does; run
`python -m openjph_tpu_torch.apps.compress` (or the `ojph_gpu_compress`
entry point).  The encode runs on the card (encode_gpu), with no host
fallback: without a card, or for a stream the port does not encode yet,
the run fails with the error's message and writes no output file.
"""
from __future__ import annotations

import os
import sys
import time

import numpy as np

from ..gpu.encode_pipeline import encode_gpu
from ..utils import imageio
from .cli import ArgError, Args

USAGE = """ojph-gpu-compress -i input -o output.j2c [options]
Input formats: .pgm .ppm .pfm .yuv .raw/.rawl .dpx
Options (ojph_compress dialect):
 -i, -o               input/output files
 -num_decomps <n>     number of decompositions (default 5)
 -qstep <f>           quantization step for lossy (9/7)
 -qfactor <1..100>    quality factor (implies lossy)
 -reversible <bool>   true = lossless 5/3
 -colour_trans <bool> RCT/ICT on first 3 components
 -prog_order <name>   LRCP RLCP RPCL PCRL CPRL (default RPCL)
 -block_size {x,y}    codeblock size (default {64,64})
 -precincts {x,y},... precinct sizes, finest first
 -tile_size {x,y}  -tile_offset {x,y}  -image_offset {x,y}
 -tileparts <R|C|RC>  tile part divisions
 -tlm_marker <bool>   write a TLM marker
 -profile <name>      IMF or BROADCAST
 -com <string>        comment marker text
 -dims {w,h} -num_comps <n> -signed <b,..> -bit_depth <n,..>
 -downsamp {x,y},...  (raw/yuv inputs)
"""

PROG_ORDERS = ['LRCP', 'RLCP', 'RPCL', 'PCRL', 'CPRL']


def _load_input(args: Args):
    path = args.get('-i')
    if path is None:
        raise ArgError('-i is required')
    ext = os.path.splitext(path)[1].lower()
    bit_depth = None
    is_signed = False
    downsamp = None
    if ext in ('.pgm', '.ppm'):
        img = imageio.read_pnm(path)
        bit_depth = 8 if img.dtype == np.uint8 else 16
        planes = [img[..., c] for c in range(img.shape[2])] \
            if img.ndim == 3 else [img]
    elif ext == '.pfm':
        img = imageio.read_pfm(path)
        bit_depth = args.get_int('-bit_depth', 32)
        planes = [img[..., c] for c in range(img.shape[2])] \
            if img.ndim == 3 else [img]
        raise ArgError('PFM (float) encoding requires the NLT path; '
                       'not supported yet')
    elif ext in ('.raw', '.rawl'):
        dims = args.get_size('-dims')
        if dims is None:
            raise ArgError('-dims {w,h} is required for .raw input')
        bds = args.get_int_list('-bit_depth') or [8]
        sgn = [s.lower() == 'true'
               for s in (args.get('-signed') or 'false').split(',')]
        nc = args.get_int('-num_comps', 1)
        planes = []
        # single-component raw only (like raw_in)
        if nc != 1:
            raise ArgError('.raw supports one component')
        planes = [imageio.read_raw(path, dims[0], dims[1], bds[0],
                                   sgn[0])]
        bit_depth, is_signed = bds[0], sgn[0]
    elif ext == '.yuv':
        dims = args.get_size('-dims')
        if dims is None:
            raise ArgError('-dims {w,h} is required for .yuv input')
        bds = args.get_int_list('-bit_depth') or [8]
        downsamp = args.get_size_list('-downsamp') or [(1, 1)]
        nc = args.get_int('-num_comps', 3)
        ds = list(downsamp) + [downsamp[-1]] * (nc - len(downsamp))
        # first component is never downsampled in ojph's yuv layout
        ds[0] = (1, 1)
        planes = imageio.read_yuv(path, dims[0], dims[1], bds[0], ds)
        bit_depth = bds[0]
        downsamp = ds
    elif ext in ('.tif', '.tiff'):
        img = imageio.read_tiff(path)
        bit_depth = 8 if img.dtype.itemsize == 1 else 16
        planes = [img[..., c] for c in range(img.shape[2])] \
            if img.ndim == 3 else [img]
    elif ext == '.dpx':
        img, bit_depth = imageio.read_dpx(path)
        planes = [img[..., c] for c in range(img.shape[2])] \
            if img.ndim == 3 else [img]
    else:
        raise ArgError(f'unsupported input extension {ext}')
    return [np.asarray(p).astype(np.int32) for p in planes], \
        bit_depth, is_signed, downsamp


def main(argv=None, device='cuda') -> int:
    """Run the CLI on ``argv`` (default: the command line); the encode
    runs on ``device`` (the card from the command line; Python callers
    may pass 'cpu' for the kernels' plain versions).  Returns the exit
    code."""
    argv = sys.argv[1:] if argv is None else argv
    if not argv or argv[0] in ('-h', '--help'):
        print(USAGE)
        return 0
    try:
        args = Args(argv)
        planes, bit_depth, is_signed, downsamp = _load_input(args)
        out = args.get('-o')
        if out is None:
            raise ArgError('-o is required')
        reversible = args.get_bool('-reversible', False)
        qstep = args.get_float('-qstep')
        qfactor = args.get_int('-qfactor')
        if qfactor is not None and qstep is not None:
            raise ArgError('-qfactor and -qstep cannot be used together')
        po_name = args.get('-prog_order', 'RPCL').upper()
        if po_name not in PROG_ORDERS:
            raise ArgError(f'bad -prog_order {po_name}')
        ct = args.get('-colour_trans')
        kwargs = dict(
            bit_depth=args.get_int('-bit_depth', bit_depth) or bit_depth,
            is_signed=is_signed,
            reversible=reversible,
            num_decomps=args.get_int('-num_decomps', 5),
            prog_order=PROG_ORDERS.index(po_name),
            color_transform=None if ct is None
            else ct.lower() == 'true',
            base_delta=qstep,
            block_size=args.get_size('-block_size', (64, 64)),
            tlm_marker=args.get_bool('-tlm_marker', False),
            tile_size=args.get_size('-tile_size'),
            tile_offset=args.get_size('-tile_offset', (0, 0)),
            image_offset=args.get_size('-image_offset', (0, 0)),
            precincts=args.get_size_list('-precincts'),
            downsamplings=downsamp,
            qfactor=qfactor,
            tileparts=args.get('-tileparts'),
            profile=args.get('-profile'),
        )
        com = args.get('-com')
        if com is not None:
            kwargs['comments'] = [com]
        args.get('-dims')
        args.get('-num_comps')
        args.get('-signed')
        args.check_unused()

        t0 = time.time()
        stream = encode_gpu(planes if len(planes) > 1 else planes[0],
                            device=device, **kwargs)
        with open(out, 'wb') as f:
            f.write(stream)
        print(f'Elapsed time = {time.time() - t0:f}')
        return 0
    # RuntimeError: no card, or an encoder's overflow
    except (ArgError, ValueError, OSError, RuntimeError) as e:
        print(f'ojph-gpu-compress: {e}', file=sys.stderr)
        return 1


if __name__ == '__main__':
    sys.exit(main())
