"""The port's entry points (openjph_tpu_torch.entry) on the CPU,
against the JAX package's (__graft_entry__.py).  Running the JAX
``entry()`` graph on the CPU costs ~12 s, so the port's runner is held
to the JAX package's decode of the same stream instead, bit-exact (5/3),
and its plan to the JAX ``_build_plan``'s lane groups.
``dryrun_multichip(2, device='cpu')`` runs its five stages on a
two-entry CPU mesh and two gloo processes."""
import numpy as np
import pytest
import torch

import openjph_tpu
from openjph_tpu.tpu.pipeline import TpuDecoder
from openjph_tpu.tpu.pipeline import _build_plan as jax_build_plan

from openjph_tpu_torch import entry as E


def _live_lanes(plan):
    """(width, height, padded lanes, live lanes) of each lane group."""
    pos = np.asarray(plan.lanes[0])
    out, s0 = [], 0
    for g in plan.groups:
        out.append((g.w, g.h, g.n_pad, int((pos[s0:s0 + g.n_pad] >= 0)
                                           .sum())))
        s0 += g.n_pad
    return out


def test_entry_decodes_the_sample_to_its_image():
    stream, img = E._sample_stream()
    runner, args = E.entry(device='cpu')
    assert not runner.raw  # the dense layout: K1 on the card
    errs, outs = runner(*args)
    assert not errs.any()
    assert len(outs) == 1 and len(outs[0]) == 1
    got = outs[0][0]
    assert got.dtype == torch.uint8 and tuple(got.shape) == (1, 256, 256)
    got = got[0].numpy().astype(np.int32)
    assert np.array_equal(got, img)
    assert np.array_equal(got, openjph_tpu.decode(stream)[0])


def test_entry_plan_has_the_jax_lane_groups():
    stream, _ = E._sample_stream()
    runner, _ = E.entry(device='cpu')
    want = _live_lanes(jax_build_plan(TpuDecoder(stream)))
    assert _live_lanes(runner.plan) == want
    assert sum(n for *_, n in want) > 0


def test_entry_points_need_cuda_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is present')
    with pytest.raises(RuntimeError, match='CUDA'):
        E.entry()
    with pytest.raises(RuntimeError, match='CUDA'):
        E.dryrun_multichip(1)


def test_dryrun_multichip_on_two_cpu_devices():
    E.dryrun_multichip(2, device='cpu')
