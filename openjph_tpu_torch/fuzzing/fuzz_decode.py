"""Decode fuzzer of the port (the JAX package's fuzzing/fuzz_decode.py,
itself the analogue of the reference's libFuzzer target
fuzzing/fuzz_targets/ojph_expand_fuzz_target.cpp).

Strategy: start from the seed pool (the committed OpenJPH corpus of
fuzzing/seed_corpus/ and six streams of the port's own encode), apply
random byte mutations (flips, truncations, splices, inserts) and decode
each mutated stream on a device, strict and ``resilient=True``, against
the port's CPU decode of the same bytes (``device='cpu'``, dense runner:
the kernels' plain versions).  The contract under fuzz:

- strict decode raises only ValueError / EOFError (OjphError is a
  ValueError), and accepts and rejects the same streams as the CPU
  decode, with the same exception type;
- resilient decode accepts and rejects the same streams as the CPU
  decode (it raises only while the headers do not parse);
- where both accept, the outputs agree (``_paths_agree``: reversible
  components bit-exact, irreversible ones within 1 after clipping).

Any other exception, a CUDA error or an out-of-memory error is a fault
of the port: nothing here catches it.

    python -m openjph_tpu_torch.fuzzing.fuzz_decode [iterations] [seed] \\
        [--device cpu|cuda] [--dense]

runs ``iterations`` mutations (default 1000) from ``seed`` (default 0)
on the card (raw runner; ``--dense``: the dense-words runner), more than
150 in fresh-process batches of 150, each under its own time limit, so a
stream that hangs a kernel fails with its batch's seed named.  The last
line is ``done: {json}``, the stats of :func:`run`.
"""
import json
import os
import subprocess
import sys

import numpy as np
import torch

from ..core import markers as mk
from ..gpu import block_decode_cuda, block_refine_cuda
from ..gpu.pipeline import decode_gpu, resolve_device

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CORPUS = os.path.join(REPO, 'fuzzing', 'seed_corpus')
# iterations a fresh process runs, and the seconds it may take
BATCH = 150
BATCH_TIMEOUT = 1800


def load_corpus(path=None):
    """The committed foreign-seed corpus: ojph_compress-encoded streams
    across the config grid plus oracle-validated Part-2 exotics
    (tools/gen_fuzz_corpus.py), in file-name order; ``path`` defaults to
    the repository's fuzzing/seed_corpus/."""
    d = CORPUS if path is None else path
    if not os.path.isdir(d):
        return []
    out = []
    for f in sorted(os.listdir(d)):
        if f.endswith('.j2c'):
            with open(os.path.join(d, f), 'rb') as fh:
                out.append(fh.read())
    return out


def make_seeds(device='cuda'):
    """The corpus and six streams of the port's encode on ``device``
    (byte-identical to the JAX package's encode, so the pool is the JAX
    harness's): a 3-level 32x32-codeblock gray frame, RGB 5/3 and 9/7, a
    tiled LRCP frame, and a 3-pass and a causal 2-pass frame, whose
    SigProp / MagRef segments reach the refinement decoder."""
    from .. import encode
    rng = np.random.RandomState(7)
    seeds = list(load_corpus())
    img = rng.randint(0, 256, (64, 80)).astype(np.int32)
    seeds.append(encode([img], device=device, reversible=True,
                        num_decomps=3, block_size=(32, 32)))
    rgb = rng.randint(0, 256, (48, 52, 3)).astype(np.int32)
    seeds.append(encode(rgb, device=device, reversible=True))
    seeds.append(encode(rgb, device=device, reversible=False,
                        base_delta=1 / 256))
    seeds.append(encode([img], device=device, reversible=True,
                        tile_size=(32, 32), prog_order=0))
    sp = img.copy()
    sp[rng.rand(64, 80) < 0.5] = 0
    seeds.append(encode([sp], device=device, reversible=True, num_decomps=2,
                        ht_passes=3))
    seeds.append(encode([sp], device=device, reversible=True, num_decomps=2,
                        ht_passes=2, vert_causal=True))
    return seeds


def mutate(rng, data: bytes) -> bytes:
    b = bytearray(data)
    op = rng.randint(0, 4)
    if op == 0 and len(b) > 2:                 # flip random bytes
        for _ in range(rng.randint(1, 9)):
            b[rng.randint(0, len(b))] ^= 1 << rng.randint(0, 8)
    elif op == 1 and len(b) > 4:               # truncate
        b = b[:rng.randint(2, len(b))]
    elif op == 2 and len(b) > 8:               # splice a chunk
        i = rng.randint(0, len(b) - 4)
        j = rng.randint(0, len(b) - 4)
        n = rng.randint(1, 64)
        b[i:i + n] = b[j:j + n]
    else:                                      # random insert
        i = rng.randint(0, len(b))
        b[i:i] = bytes(rng.randint(0, 256, rng.randint(1, 16),
                                   dtype=np.uint8))
    return bytes(b)


def _paths_agree(hdr, host_planes, dev_planes, ctx):
    """Cross-path output contract: the same components and shapes;
    reversible components bit-exact; irreversible (9/7 float) components
    within PAE 1 after clamping to the sample range: CPU and GPU float
    pipelines can differ in the last ULP, the +-1 integer tolerance the
    reference test suite grants its own decoder (test_executables.cpp
    TOL_INTEGER)."""
    if len(host_planes) != len(dev_planes) or any(
            np.shape(a) != np.shape(b)
            for a, b in zip(host_planes, dev_planes)):
        raise AssertionError(
            f'component shapes differ ({ctx}): '
            f'{[np.shape(a) for a in host_planes]} against '
            f'{[np.shape(b) for b in dev_planes]}')
    for c, (a, b) in enumerate(zip(host_planes, dev_planes)):
        ci = hdr.siz.comps[c]
        lo, hi = ((-(1 << (ci.bit_depth - 1)),
                   (1 << (ci.bit_depth - 1)) - 1)
                  if ci.is_signed else (0, (1 << ci.bit_depth) - 1))
        aa = np.clip(a, lo, hi).astype(np.int64)
        bb = np.clip(b, lo, hi).astype(np.int64)
        if hdr.get_cod(c).is_reversible:
            if not np.array_equal(aa, bb):
                raise AssertionError(f'device / CPU divergence ({ctx}, '
                                     f'comp {c})')
        else:
            pae = int(np.abs(aa - bb).max()) if aa.size else 0
            if pae > 1:
                raise AssertionError(f'device / CPU 9/7 PAE {pae} ({ctx}, '
                                     f'comp {c})')


def without_traceback(err):
    """``err`` and the exceptions it chains with their tracebacks
    dropped: a kept traceback's frames would hold the failed call's
    device tensors (the runner's inputs and outputs) for as long as the
    error is kept."""
    e = err
    while e is not None:
        e.__traceback__ = None
        e = e.__context__
    return err


def decode_or_error(data: bytes, device, raw: bool, resilient: bool):
    """(planes, None) when the port's decode on ``device`` accepts
    ``data``, (None, the error without its traceback) when it raises
    ValueError or EOFError; any other exception propagates."""
    try:
        return decode_gpu(data, device=device, raw=raw,
                          resilient=resilient), None
    except (ValueError, EOFError) as e:
        return None, without_traceback(e)


def cpu_reference(data: bytes):
    """The port's CPU decode of ``data`` (dense runner), strict and
    resilient: two ``decode_or_error`` results."""
    return (decode_or_error(data, 'cpu', False, False),
            decode_or_error(data, 'cpu', False, True))


def _verdict(out, err) -> str:
    return 'accepted' if err is None else f'{type(err).__name__}: {err}'


def check_stream(data: bytes, device, raw: bool, refs, ctx: str):
    """Decode ``data`` on ``device`` (runner mode ``raw``) strict and
    resilient and hold each to its CPU result in ``refs`` (as
    cpu_reference returns them): the same acceptance and exception type,
    and agreeing outputs where both accept.  Returns the two device
    results."""
    got = []
    for resilient, (want, werr) in zip((False, True), refs):
        out, err = decode_or_error(data, device, raw, resilient)
        mode = 'resilient' if resilient else 'strict'
        if type(err) is not type(werr):
            raise AssertionError(
                f'{mode} decode on {device} (raw={raw}): '
                f'{_verdict(out, err)}; on the CPU: {_verdict(want, werr)} '
                f'({ctx})')
        if out is not None:
            _paths_agree(mk.read_main_header(data), want, out,
                         f'{mode}, raw={raw}, {ctx}')
        got.append((out, err))
    return got


def _launches() -> dict:
    return {**block_decode_cuda.LAUNCHES, **block_refine_cuda.LAUNCHES}


def run(iterations=1000, seed=0, device='cuda', raw=True, seed_subset=None,
        quiet=False):
    """Decode ``iterations`` mutated streams (RandomState(seed) draws a
    seed of make_seeds and a mutation, as the JAX harness does) on
    ``device`` in runner mode ``raw``, each held to the port's CPU decode
    by check_stream.  ``seed_subset`` limits the pool to every Nth seed.
    Returns the JAX harness's stats of the CPU decode (``ok``,
    ``valueerror``, ``eof``, ``resilient_ok``), the device's accepts
    (``device_ok``, ``device_resilient_ok``), the decode kernels'
    launches over the mutations, and on a CUDA device the peak of its
    allocated memory after 25 streams and after all of them, and the
    memory still allocated then (``peak_bytes_at_25``, ``peak_bytes``,
    ``allocated_bytes_at_25``, ``allocated_bytes``)."""
    dev = resolve_device(device)
    seeds = make_seeds(dev)
    if seed_subset:
        seeds = seeds[::max(1, len(seeds) // seed_subset)][:seed_subset]
    rng = np.random.RandomState(seed)
    stats = {'ok': 0, 'valueerror': 0, 'eof': 0, 'resilient_ok': 0,
             'device_ok': 0, 'device_resilient_ok': 0}
    cuda = dev.type == 'cuda'
    if cuda:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    before = _launches()
    for it in range(iterations):
        data = mutate(rng, seeds[rng.randint(0, len(seeds))])
        refs = cpu_reference(data)
        (out, err), (res_out, _) = refs
        if out is not None:
            stats['ok'] += 1
        elif isinstance(err, EOFError):
            stats['eof'] += 1
        else:
            stats['valueerror'] += 1
        stats['resilient_ok'] += res_out is not None
        got = check_stream(data, dev, raw, refs,
                           f'iteration {it} of seed {seed}')
        stats['device_ok'] += got[0][0] is not None
        stats['device_resilient_ok'] += got[1][0] is not None
        for n, sfx in ((25, '_at_25'), (iterations, '')):
            if cuda and it + 1 == n:
                torch.cuda.synchronize(dev)
                stats['peak_bytes' + sfx] = \
                    torch.cuda.max_memory_allocated(dev)
                stats['allocated_bytes' + sfx] = \
                    torch.cuda.memory_allocated(dev)
        if not quiet and it and it % 100 == 0:
            print(f'{it}: {stats}', flush=True)
    after = _launches()
    stats['launches'] = {k: after[k] - before[k] for k in after}
    if not quiet:
        print('done: ' + json.dumps(stats), flush=True)
    return stats


def _batches(iterations: int, seed: int, device: str, dense: bool) -> dict:
    """Run ``iterations`` in fresh processes of BATCH iterations each
    (seeds seed, seed + BATCH, ...), each under BATCH_TIMEOUT seconds;
    returns their stats summed (memory: the largest)."""
    total: dict = {}
    at = 0
    while at < iterations:
        n = min(BATCH, iterations - at)
        # by the module's own name: under `python -m` __name__ is
        # '__main__'
        cmd = [sys.executable, '-m', __spec__.name, str(n),
               str(seed + at), '--device', device, '--child'] \
            + (['--dense'] if dense else [])
        try:
            r = subprocess.run(cmd, capture_output=True, text=True,
                               timeout=BATCH_TIMEOUT, cwd=REPO)
        except subprocess.TimeoutExpired:
            raise RuntimeError(
                f'the batch of {n} iterations from seed {seed + at} ran '
                f'over {BATCH_TIMEOUT} s') from None
        if r.returncode != 0:
            raise RuntimeError(
                f'the batch of {n} iterations from seed {seed + at} '
                f'exited {r.returncode}:\n{r.stdout[-2000:]}'
                f'{r.stderr[-4000:]}')
        line = [ln for ln in r.stdout.splitlines()
                if ln.startswith('done: ')][-1]
        for k, v in json.loads(line[len('done: '):]).items():
            if k == 'launches':
                acc = total.setdefault(k, {})
                for kk, vv in v.items():
                    acc[kk] = acc.get(kk, 0) + vv
            elif 'bytes' in k:
                total[k] = max(total.get(k, 0), v)
            else:
                total[k] = total.get(k, 0) + v
        print(f'{at + n}/{iterations}: {line}', flush=True)
        at += n
    return total


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('iterations', nargs='?', type=int, default=1000)
    ap.add_argument('seed', nargs='?', type=int, default=0)
    ap.add_argument('--device', default='cuda')
    ap.add_argument('--dense', action='store_true',
                    help='the dense-words runner (K1) instead of the raw '
                         'one (K2)')
    ap.add_argument('--child', action='store_true', help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.iterations > BATCH and not args.child:
        stats = _batches(args.iterations, args.seed, args.device,
                         args.dense)
        print('done: ' + json.dumps(stats), flush=True)
        return 0
    run(args.iterations, args.seed, args.device, raw=not args.dense)
    return 0


if __name__ == '__main__':
    sys.exit(main())
