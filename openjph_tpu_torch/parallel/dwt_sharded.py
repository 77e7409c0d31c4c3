"""Row-sharded DWT lifting with halo rows exchanged over
``torch.distributed`` (the JAX package's parallel/dwt_sharded.py).

For planes too large for one device, each process of a group holds a
band of rows, and every vertical lifting step takes one boundary row
from a neighbouring process: the counterpart of the reference's
``line_buf`` pre_size margin cells (ojph_mem.h:176-189) and the ±1
sample overlap of its lifting ring (ojph_resolution.cpp:468-520).  The
first and last process extend their own edge row symmetrically, as the
unsharded lifting does.  Horizontal lifting is row-parallel and stays
local (gpu/dwt.py).

Halo rows travel by point-to-point sends and receives.  Over gloo a
CUDA row is staged through host memory explicitly; over NCCL it is
sent from the device.  (NCCL refuses two ranks on one device, so
processes sharing a card use gloo.)

Constraints: the global vertical origin is even, and every process
holds an even number of rows, so the even / odd phase split never
crosses a process boundary.  Planes may carry leading axes; the rows
are axis -2.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from ..core.atk import ATK_IRV97, ATK_REV53
from ..gpu import dwt
from ..gpu.dwt import _rev_lift

_ROWS = -2


def _kernel(reversible: bool):
    return ATK_REV53 if reversible else ATK_IRV97


def _peer(group, r: int) -> int:
    return r if group is None else dist.get_global_rank(group, r)


def _exchange(row, to, frm, group):
    """Send ``row`` to group rank ``to`` and return the like row received
    from group rank ``frm`` (either None: no send, or no receive and a
    None return)."""
    staged = (row.device.type != 'cpu'
              and dist.get_backend(group) != 'nccl')
    out = row.contiguous().cpu() if staged else row.contiguous()
    reqs = []
    if to is not None:
        reqs.append(dist.isend(out, _peer(group, to), group=group))
    buf = None
    if frm is not None:
        buf = torch.empty_like(out)
        reqs.append(dist.irecv(buf, _peer(group, frm), group=group))
    for r in reqs:
        r.wait()
    if buf is None:
        return None
    return buf.to(row.device) if staged else buf


def _fetch_next_first(x, group=None):
    """Every process receives the *next* process's first row; the last
    one its own last row (symmetric extension)."""
    n, i = dist.get_world_size(group), dist.get_rank(group)
    recv = _exchange(x.narrow(_ROWS, 0, 1), i - 1 if i > 0 else None,
                     i + 1 if i < n - 1 else None, group)
    return x.narrow(_ROWS, x.shape[_ROWS] - 1, 1) if recv is None else recv


def _fetch_prev_last(x, group=None):
    """Every process receives the *previous* process's last row; the
    first one its own first row."""
    n, i = dist.get_world_size(group), dist.get_rank(group)
    recv = _exchange(x.narrow(_ROWS, x.shape[_ROWS] - 1, 1),
                     i + 1 if i < n - 1 else None,
                     i - 1 if i > 0 else None, group)
    return x.narrow(_ROWS, 0, 1) if recv is None else recv


def _vert_step(kernel, j: int, dst, src, off: int, group, synthesis: bool):
    """One sharded vertical lifting step j: dst[i] +-= f(src[i+off-1],
    src[i+off]) over the halo-extended local rows of src."""
    if off == 0:
        ext = torch.cat([_fetch_prev_last(src, group), src], dim=_ROWS)
    else:
        ext = torch.cat([src, _fetch_next_first(src, group)], dim=_ROWS)
        off = 0
    m = dst.shape[_ROWS]
    s0 = ext.narrow(_ROWS, off, m)
    s1 = ext.narrow(_ROWS, off + 1, m)
    if kernel.reversible:
        a, b, e = kernel.steps[j]
        d = _rev_lift(a, b, e, s0, s1)
    else:
        d = torch.tensor(kernel.steps[j], dtype=torch.float32) * (s0 + s1)
    return dst - d if synthesis else dst + d


def fwd_vert_sharded(x, group=None, reversible: bool = True):
    """Vertical analysis of this process's rows of a row-sharded plane;
    returns its (L, H) halves.  The steps run in gpu/dwt.py's order and
    arithmetic, so the shards equal the unsharded analysis's rows."""
    k = _kernel(reversible)
    P = [x[..., 0::2, :], x[..., 1::2, :]]
    for j in range(k.num_steps - 1, -1, -1):
        bidx = j & 1
        # phase parity of step j at an even origin (fwd_atk_1d's ev_j)
        off = 0 if bidx == 0 else 1
        P[bidx] = _vert_step(k, j, P[bidx], P[1 - bidx], off, group,
                             False)
    if not k.reversible:
        P[0] = P[0] * torch.tensor(1.0 / k.K, dtype=torch.float32)
        P[1] = P[1] * torch.tensor(k.K, dtype=torch.float32)
    return P[0], P[1]


def inv_vert_sharded(L, H, group=None, reversible: bool = True):
    """Vertical synthesis of row-sharded half planes; returns this
    process's interleaved rows."""
    k = _kernel(reversible)
    if k.reversible:
        aug, oth = L, H
    else:
        aug = L * torch.tensor(k.K, dtype=torch.float32)
        oth = H * torch.tensor(1.0 / k.K, dtype=torch.float32)
    ev = True
    for j in range(k.num_steps):
        aug = _vert_step(k, j, aug, oth, 0 if ev else 1, group, True)
        aug, oth = oth, aug
        ev = not ev
    if k.num_steps % 2:
        aug, oth = oth, aug
    return dwt._interleave(aug, oth, True, L.ndim + _ROWS)


def fwd_dwt2d_sharded(x, group=None, reversible: bool = True):
    """One 2D analysis level of a row-sharded plane at even origins:
    sharded vertical lifting, then local horizontal lifting.  Returns
    this process's rows of (LL, HL, LH, HH)."""
    k = _kernel(reversible)
    Lv, Hv = fwd_vert_sharded(x, group, reversible)
    LL, HL = dwt.fwd_atk_1d(Lv, True, x.ndim - 1, k)
    LH, HH = dwt.fwd_atk_1d(Hv, True, x.ndim - 1, k)
    return LL, HL, LH, HH


def inv_dwt2d_sharded(LL, HL, LH, HH, group=None, reversible: bool = True):
    """Inverse of fwd_dwt2d_sharded."""
    k = _kernel(reversible)
    Lv = dwt.inv_atk_1d(LL, HL, True, LL.ndim - 1, k)
    Hv = dwt.inv_atk_1d(LH, HH, True, LL.ndim - 1, k)
    return inv_vert_sharded(Lv, Hv, group, reversible)


def seeded_plane(seed: int, h: int, w: int, reversible: bool):
    """The seeded plane of the multi-process check: integers in
    [-500, 500) for 5/3, uniform in [-1, 1) for 9/7."""
    import numpy as np
    rng = np.random.RandomState(seed + (0 if reversible else 1))
    if reversible:
        return rng.randint(-500, 500, (h, w)).astype(np.int32)
    return rng.uniform(-1, 1, (h, w)).astype(np.float32)


def _worker_main(argv=None) -> int:
    """Multi-process check of the sharded DWT, one process per rank:

    python -m openjph_tpu_torch.parallel.dwt_sharded \\
        --coordinator H:P --num-processes N --process-id K \\
        [--size WxH] [--seed S] [--device cuda|cpu] [--backend gloo] \\
        [--out DIR]

    Every process makes the same seeded plane (seeded_plane), takes its
    band of rows, runs one 2D analysis and synthesis level sharded, 5/3
    and 9/7, and holds its rows of each band, and of the synthesis,
    equal to the unsharded gpu/dwt.py on the same device (and 5/3's
    synthesis to the input).  ``--out`` writes its rows to
    DIR/rank<K>.npz.  Prints one line starting 'dwt_sharded OK'."""
    import argparse
    import json
    import os

    import numpy as np

    from ..gpu.pipeline import resolve_device
    ap = argparse.ArgumentParser()
    ap.add_argument('--coordinator', required=True)
    ap.add_argument('--num-processes', type=int, required=True)
    ap.add_argument('--process-id', type=int, required=True)
    ap.add_argument('--size', default='96x128')
    ap.add_argument('--seed', type=int, default=3)
    ap.add_argument('--device', default='cuda')
    ap.add_argument('--backend', default='gloo')
    ap.add_argument('--out')
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    n, pid = args.num_processes, args.process_id
    dist.init_process_group(args.backend,
                            init_method=f'tcp://{args.coordinator}',
                            world_size=n, rank=pid)
    try:
        w, h = (int(v) for v in args.size.split('x'))
        if h % (2 * n):
            raise ValueError(f'{h} rows do not split into even bands '
                             f'over {n} processes')
        rows = slice(pid * h // n, (pid + 1) * h // n)
        half = slice(rows.start // 2, rows.stop // 2)
        saved, checked = {}, []
        for rev in (True, False):
            name = 'rev53' if rev else 'irv97'
            x = torch.from_numpy(seeded_plane(args.seed, h, w, rev)).to(dev)
            bands = fwd_dwt2d_sharded(x[rows], None, rev)
            back = inv_dwt2d_sharded(*bands, None, rev)
            ref = dwt.fwd_dwt2d(x, True, True, rev)
            ref_back = dwt.inv_dwt2d(*ref, True, True, rev)
            for b, (got, want) in enumerate(zip(bands, ref)):
                if not torch.equal(got, want[half]):
                    raise AssertionError(f'{name} band {b} differs from '
                                         f'the unsharded analysis')
            if not torch.equal(back, ref_back[rows]):
                raise AssertionError(f'{name} synthesis differs from the '
                                     f'unsharded synthesis')
            if rev and not torch.equal(back, x[rows]):
                raise AssertionError('5/3 synthesis is not lossless')
            checked.append(name)
            for b, t in zip(('LL', 'HL', 'LH', 'HH'), bands):
                saved[f'{name}_{b}'] = t.cpu().numpy()
            saved[f'{name}_back'] = back.cpu().numpy()
        if args.out:
            np.savez(os.path.join(args.out, f'rank{pid}.npz'), **saved)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    print('dwt_sharded OK ' + json.dumps({
        'process': pid, 'processes': n, 'shape': [h, w],
        'rows': [rows.start, rows.stop], 'device': str(dev),
        'backend': args.backend, 'equal_to_unsharded': checked}),
        flush=True)
    return 0


if __name__ == '__main__':
    import sys
    sys.exit(_worker_main())
