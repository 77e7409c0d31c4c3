"""The readers of the port's burst spans (``harness/spans.py`` and the
metrics that use it): on a hand-built record, ms a frame and ms a burst
of the slowest 5%, 0.0 for a traced run whose stage never ran, None for
an untraced run or a program without burst spans; every such entry of
BENCHMARK.json has its reader; a traced run of each decode cell on the
CPU (the port's plain versions, small frames) reads every one of them;
on the card, a traced decode records the staging ring's stages."""
import json
import math

import numpy as np
import pytest

from gpubench.harness import cell as cell_mod
from gpubench.harness import manifest, metrics
from gpubench.harness.cell import Record
from gpubench.loops.closed import LoopRecord

# reader -> (stages it sums, or the stage whose tail it reads); the
# collector's pauses count only under bursts (their burst_seconds)
BURST_ONLY = {'host.gc_pause_ms'}
PER_FRAME = {
    'decode.queue_wait_ms': ('decode.queue_wait',),
    'decode.collect_wait_ms': ('decode.collect_wait',),
    'decode.upload_ms': ('decode.dispatch.upload',),
    'decode.rest_launch_ms': ('decode.dispatch.rest',),
    'host.gc_pause_ms': ('host.gc',),
    'decode.cache_miss_ms': ('decode.compile', 'decode.staging_alloc'),
}
TAIL = {
    'decode.tail_dispatch_ms': 'decode.dispatch',
    'decode.tail_host_prep_ms': 'decode.host_prep',
    'decode.tail_gc_ms': 'host.gc',
}


def _entries():
    return [m for m in manifest.load()['per_layer']
            if m['name'].rsplit('.', 1)[0] in PER_FRAME.keys() | TAIL.keys()]


def _rec(stages, frames=50):
    return Record(config={}, traffic={'burst': 1}, seconds=2.0, setup_s=1.0,
                  loop=LoopRecord(window_s=2.0, frames=frames),
                  mpix=2.2, stages=stages)


def _stat(seconds, tail=None):
    s = {'seconds': seconds, 'calls': 5, 'ms_per_call': 0.0,
         'self_seconds': seconds, 'parents': [],
         'burst_seconds': seconds / 4}
    if tail is not None:
        s['tail_seconds'] = tail
    return s


def _read(name, rec):
    return metrics.reader(name)(rec, {'name': name})


@pytest.mark.parametrize('base', sorted(PER_FRAME))
def test_per_frame_readers(base):
    stages = {'decode.burst': _stat(9.0)}
    for i, s in enumerate(PER_FRAME[base]):
        stages[s] = _stat(0.1 * (i + 1))
    want = 1e3 * sum(0.1 * (i + 1) for i in range(len(PER_FRAME[base]))) / 50
    if base in BURST_ONLY:
        want /= 4
    for sfx in ('stream', 'frame'):
        name = f'{base}.{sfx}'
        assert _read(name, _rec(stages)) == pytest.approx(want)
        # traced, never ran: 0; untraced, or no burst span: nothing
        assert _read(name, _rec({'decode.burst': _stat(9.0)})) == 0.0
        assert _read(name, _rec(None)) is None
        assert _read(name, _rec({s: _stat(1.0)
                                 for s in PER_FRAME[base]})) is None


@pytest.mark.parametrize('base', sorted(TAIL))
def test_tail_readers(base):
    name = base + '.frame'
    stage = TAIL[base]
    stages = {'decode.burst': _stat(9.0, tail=0.05),
              stage: _stat(1.0, tail=0.012)}
    assert _read(name, _rec(stages)) == pytest.approx(12.0)
    assert _read(name, _rec({'decode.burst': _stat(9.0, tail=0.05)})) == 0.0
    assert _read(name, _rec(None)) is None
    # fewer bursts than the program's least count: no tail
    assert _read(name, _rec({'decode.burst': _stat(9.0),
                             stage: _stat(1.0)})) is None


def test_every_span_entry_has_its_reader_and_cells():
    entries = _entries()
    assert len(entries) == 2 * len(PER_FRAME) + len(TAIL)
    for m in entries:
        base, sfx = m['name'].rsplit('.', 1)
        assert metrics.reader_path(m['name']).endswith(f'/{base}.py')
        assert m['source'] == 'program_span' and m['unit'] == 'ms'
        assert (m['moves'], m['workloads']) == {
            'stream': ('decode_mpix_s', ['gray8_2k_rev53.decode_stream']),
            'frame': ('decode_frame_p95_ms',
                      ['rgb8_2k_97ict.decode_frame'])}[sfx]
    assert not any(m['name'].endswith('.stream') for m in entries
                   if m['name'].rsplit('.', 1)[0] in TAIL)


@pytest.mark.parametrize('name', ['gray8_2k_rev53.decode_stream',
                                  'rgb8_2k_97ict.decode_frame'])
def test_traced_cpu_run_reads_every_span_metric(name, monkeypatch):
    """The harness, traced, on the CPU: the span metrics of the cell are
    in its result line, finite, and the runner cache never missed."""
    from openjph_tpu_torch import trace
    monkeypatch.setattr(cell_mod, 'WARM_SECONDS', 0.2)
    # a tail from however few bursts a loaded CPU closes in the window
    monkeypatch.setattr(trace, 'TAIL_MIN_BURSTS', 1)
    c = manifest.cell(name)
    c.config = dict(c.config, width=64, height=48, num_decomps=2)
    c.traffic = dict(c.traffic, ring=2 * c.traffic['burst'])
    try:
        out = cell_mod.run_cell(c, 2**31 + 19, 2.0, True, device='cpu',
                                log=lambda m: None)
    finally:
        trace.reset()
    assert out.correct, out.check_lines
    got = json.loads(out.line)['metrics']
    want = [m['name'] for m in _entries() if name in m['workloads']]
    assert want
    for m in want:
        assert m in got and math.isfinite(got[m]['value']), m
    assert got[[m for m in want if m.startswith('decode.cache_miss_ms')][0]
               ]['value'] == 0.0


@pytest.mark.cuda
def test_traced_decode_on_the_card_records_the_staging_stages():
    """A ring's first fill allocates pinned buffers; its later uploads
    wait on the slot's last copy."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip('no CUDA device: the staging ring is pinned memory')
    import openjph_tpu_torch as ot
    from openjph_tpu_torch import trace
    img = np.random.RandomState(5).randint(0, 256, (72, 88)).astype(np.int32)
    s = ot.encode_gpu(img, reversible=True, num_decomps=2)
    vd = ot.VideoDecoder(to_device=True)
    trace.reset()
    trace.enable()
    try:
        for _ in range(6):
            vd.submit([s] * 2)
            vd.collect_on_device()
        vd.drain_errors()
    finally:
        trace.disable()
        vd.close()
    st = trace.get_stats()
    trace.reset()
    assert st['decode.staging_alloc']['calls'] >= 1
    assert st['decode.staging_alloc']['parents'] == ['decode.dispatch.upload']
    assert st['decode.upload.slot_wait']['calls'] >= 1
    parts = sum(st[n]['seconds'] for n in (
        'decode.dispatch.upload', 'decode.dispatch.tier1',
        'decode.dispatch.rest'))
    assert parts <= st['decode.dispatch']['seconds']
