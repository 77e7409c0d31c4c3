"""Encode fuzzer of the port (the JAX package's fuzzing/fuzz_encode.py,
itself the analogue of the reference's libFuzzer encode target
fuzzing/fuzz_targets/ojph_compress_fuzz_target.cpp).

Strategy: throw randomized parameter combinations and random or
adversarial sample planes (``random_params``, the JAX harness's draws)
at the port's encode on a device, against the port's CPU encode of the
same planes (``device='cpu'``: the kernels' plain versions).  The
contract under fuzz: the device encode rejects the same parameter sets
as the CPU encode, with the same exception type (ValueError; OjphError
is one); a returned codestream is byte-identical to the CPU encode's;
a reversible one decodes back on the device equal to its input, an
irreversible one decodes without error.  Where the reference's
``ojph_expand`` is built (``.oracle/bin/ojph_expand``, see
tools/gen_fuzz_corpus.py) it also decodes a random subset of the
streams, as in the JAX harness; the repository does not hold it, so
that step runs only where it was built by hand.

    python -m openjph_tpu_torch.fuzzing.fuzz_encode [iterations] [seed] \\
        [--device cpu|cuda]
"""
import os
import subprocess
import sys
import tempfile

import numpy as np

from ..gpu.pipeline import resolve_device
from .fuzz_decode import without_traceback

ORACLE = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), '.oracle', 'bin', 'ojph_expand')


def random_params(rng):
    """One randomized encode() kwarg set + matching image planes."""
    h = int(rng.randint(1, 180))
    w = int(rng.randint(1, 180))
    nc = int(rng.choice([1, 1, 1, 3, 3, 4]))
    bd = int(rng.choice([1, 2, 4, 8, 8, 10, 12, 16]))
    sgn = bool(rng.randint(0, 2))
    kw = dict(bit_depth=bd, is_signed=sgn,
              reversible=bool(rng.randint(0, 2)),
              num_decomps=int(rng.randint(0, 7)),
              prog_order=int(rng.randint(0, 5)))
    if not kw['reversible']:
        kw['base_delta'] = float(rng.choice(
            [1 / 4096, 1 / 256, 1 / 64, 0.05]))
    bs = 1 << rng.randint(2, 7)
    kw['block_size'] = (bs, bs)
    if rng.randint(0, 3) == 0:
        ts = (int(rng.randint(8, 128)), int(rng.randint(8, 128)))
        kw['tile_size'] = ts
    if rng.randint(0, 4) == 0:
        p = 1 << rng.randint(5, 9)
        kw['precincts'] = [(p, p)]
    if rng.randint(0, 4) == 0:
        kw['tlm_marker'] = True
    if rng.randint(0, 5) == 0:
        kw['tileparts'] = str(rng.choice(['R', 'C', 'RC']))
    lo = -(1 << (bd - 1)) if sgn else 0
    hi = (1 << (bd - 1)) if sgn else (1 << bd)
    kind = rng.randint(0, 4)
    if kind == 0:
        planes = [rng.randint(lo, hi, (h, w)).astype(np.int32)
                  for _ in range(nc)]
    elif kind == 1:     # constant extremes
        planes = [np.full((h, w), rng.choice([lo, hi - 1]), np.int32)
                  for _ in range(nc)]
    elif kind == 2:     # ramps (max correlation)
        yy, xx = np.mgrid[0:h, 0:w]
        planes = [((yy * 3 + xx + c) % (hi - lo) + lo).astype(np.int32)
                  for c in range(nc)]
    else:               # sparse impulses
        planes = []
        for _ in range(nc):
            p = np.zeros((h, w), np.int32)
            for _ in range(rng.randint(1, 8)):
                p[rng.randint(0, h), rng.randint(0, w)] = hi - 1
            planes.append(p)
    return planes, kw


def encode_or_error(planes, kw, device):
    """(stream, None) when the port's encode on ``device`` takes the
    parameter set, (None, the ValueError without its traceback) when it
    rejects it; any other exception propagates."""
    from .. import encode
    try:
        return encode(planes, device=device, **kw), None
    except ValueError as e:
        return None, without_traceback(e)


def check_params(planes, kw, device, ctx: str):
    """Encode on ``device`` and on the CPU, hold the two to the contract
    above, and decode a returned stream back on ``device``; returns the
    stream, or None for a rejected set."""
    from .. import decode
    want, werr = encode_or_error(planes, kw, 'cpu')
    got, err = encode_or_error(planes, kw, device)
    if type(err) is not type(werr):
        raise AssertionError(
            f'{ctx}: the encode on {device} '
            f'{"returned a stream" if err is None else repr(err)}, the CPU '
            f'encode {"returned one" if werr is None else repr(werr)} '
            f'({kw})')
    if got is None:
        return None
    if got != want:
        raise AssertionError(f'{ctx}: the encode on {device} differs from '
                             f'the CPU encode ({kw})')
    outs = decode(got, device=device)
    if kw['reversible'] and (len(outs) != len(planes) or not all(
            np.array_equal(o, p) for o, p in zip(outs, planes))):
        raise AssertionError(f'{ctx}: lossless round trip broke on '
                             f'{device} ({kw})')
    return got


def run(iterations=300, seed=0, device='cuda', quiet=False):
    """Check ``iterations`` random_params sets (RandomState(seed), the
    JAX harness's draws) with check_params on ``device``; returns
    (encoded and decoded, typed rejections, oracle-checked)."""
    dev = resolve_device(device)
    rng = np.random.RandomState(seed)
    n_ok = n_rej = n_oracle = 0
    for it in range(iterations):
        planes, kw = random_params(rng)
        stream = check_params(planes, kw, dev, f'iteration {it} of seed '
                                               f'{seed}')
        if stream is None:
            n_rej += 1          # typed rejection is within contract
            continue
        n_ok += 1
        if os.path.exists(ORACLE) and rng.randint(0, 20) == 0 \
                and len(planes) in (1, 3) \
                and kw['bit_depth'] <= 16 and not kw['is_signed']:
            with tempfile.TemporaryDirectory() as td:
                j2c = os.path.join(td, 'f.j2c')
                with open(j2c, 'wb') as fh:
                    fh.write(stream)
                ext = '.pgm' if len(planes) == 1 else '.ppm'
                r = subprocess.run(
                    [ORACLE, '-i', j2c, '-o',
                     os.path.join(td, 'f' + ext)],
                    capture_output=True, timeout=60)
                if r.returncode != 0:
                    raise AssertionError(
                        f'iter {it}: oracle rejected our stream ({kw}): '
                        f'{r.stderr[:300]}')
                n_oracle += 1
        if not quiet and (it + 1) % 50 == 0:
            print(f'{it + 1}/{iterations} ok={n_ok} rej={n_rej} '
                  f'oracle={n_oracle}', flush=True)
    if not quiet:
        print(f'done: {n_ok} encoded+decoded, {n_rej} typed '
              f'rejections, {n_oracle} oracle-checked', flush=True)
    return n_ok, n_rej, n_oracle


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('iterations', nargs='?', type=int, default=300)
    ap.add_argument('seed', nargs='?', type=int, default=0)
    ap.add_argument('--device', default='cuda')
    args = ap.parse_args(argv)
    run(args.iterations, args.seed, args.device)
    return 0


if __name__ == '__main__':
    sys.exit(main())
