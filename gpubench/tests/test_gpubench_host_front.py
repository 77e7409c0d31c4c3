"""The readers of the decode host front's parts: ``decode.t2_ms``,
``decode.plan_ms`` and ``decode.pack_ms`` (the stages
``decode.host_prep.{t2,plan,pack}`` in ms a frame) and
``decode.t2_walk_share`` (tile-parts walked in one native call over all
tile-parts parsed, in %), on hand-built records: None for an untraced
run, a program without burst spans and one without the stages (the
parent of the change that added them); each such entry of BENCHMARK.json
has its reader and its cell; a traced CPU VideoDecoder burst records the
three stages inside ``decode.host_prep`` and reads a share of 100."""
import numpy as np
import pytest

from gpubench.harness import manifest, metrics
from gpubench.harness.cell import Record
from gpubench.loops.closed import LoopRecord

STAGES = {'decode.t2_ms': 'decode.host_prep.t2',
          'decode.plan_ms': 'decode.host_prep.plan',
          'decode.pack_ms': 'decode.host_prep.pack'}
SHARE = 'decode.t2_walk_share'
CELLS = {'stream': ('decode_mpix_s', 'gray8_2k_rev53.decode_stream'),
         'frame': ('decode_frame_p95_ms', 'rgb8_2k_97ict.decode_frame')}
LAYER = ('decode host front: Tier-2, plan and pack (codec.Decoder, '
         'core.t2, gpu.pipeline._build_plan / _pack)')


def _rec(stages, frames=40):
    return Record(config={}, traffic={'burst': 1}, seconds=2.0, setup_s=1.0,
                  loop=LoopRecord(window_s=2.0, frames=frames), mpix=2.2,
                  stages=stages)


def _calls(n, seconds=None):
    s = 0.01 * n if seconds is None else seconds
    return {'seconds': s, 'calls': n, 'ms_per_call': 1e3 * s / max(n, 1),
            'self_seconds': s, 'parents': [], 'burst_seconds': s}


@pytest.mark.parametrize('sfx', sorted(CELLS))
@pytest.mark.parametrize('base', sorted(STAGES))
def test_stage_readers(base, sfx):
    read = metrics.reader(f'{base}.{sfx}')
    burst = {'decode.burst': _calls(40), 'decode.host_prep': _calls(40, 1.0)}
    # 0.12 s over 40 frames
    assert read(_rec(dict(burst, **{STAGES[base]: _calls(40, 0.12)})),
                {}) == pytest.approx(3.0)
    # the other two parts are not this reader's
    others = {s: _calls(40, 0.5) for s in STAGES.values()
              if s != STAGES[base]}
    assert read(_rec(dict(burst, **others)), {}) is None
    assert read(_rec(burst), {}) is None
    assert read(_rec(None), {}) is None
    assert read(_rec({STAGES[base]: _calls(40)}), {}) is None
    assert read(_rec(dict(burst, **{STAGES[base]: _calls(40)}),
                     frames=0), {}) is None


@pytest.mark.parametrize('sfx', sorted(CELLS))
def test_walk_share_reader(sfx):
    read = metrics.reader(f'{SHARE}.{sfx}')
    burst = {'decode.burst': _calls(40)}
    assert read(_rec(dict(burst, **{'decode.t2.walk': _calls(40)})),
                {}) == 100.0
    assert read(_rec(dict(burst, **{'decode.t2.walk': _calls(30),
                                    'decode.t2.packets': _calls(10)})),
                {}) == pytest.approx(75.0)
    assert read(_rec(dict(burst, **{'decode.t2.packets': _calls(10)})),
                {}) == 0.0
    # untraced; no burst span; a program without the stages
    assert read(_rec(None), {}) is None
    assert read(_rec({'decode.t2.walk': _calls(40)}), {}) is None
    assert read(_rec(dict(burst, **{'decode.host_prep': _calls(40)})),
                {}) is None


def test_entries_have_their_reader_and_cell():
    bases = set(STAGES) | {SHARE}
    entries = {m['name']: m for m in manifest.load()['per_layer']
               if m['name'].rsplit('.', 1)[0] in bases}
    assert sorted(entries) == sorted(f'{b}.{s}' for b in bases
                                     for s in CELLS)
    for name, m in entries.items():
        base, sfx = name.rsplit('.', 1)
        assert metrics.reader_path(name).endswith(f'/{base}.py')
        want = (('%', 'higher', 'program_counter') if base == SHARE
                else ('ms', 'lower', 'program_span'))
        assert (m['unit'], m['better'], m['source']) == want
        assert m['layer'] == LAYER
        assert (m['moves'], m['workloads']) == (CELLS[sfx][0],
                                                [CELLS[sfx][1]])


def test_traced_cpu_burst_records_the_three_parts():
    """A traced VideoDecoder on the CPU: the three parts nest inside
    ``decode.host_prep``, every tile-part is walked, and the readers read
    the stages."""
    from openjph_tpu_torch import VideoDecoder, encode, trace
    frame = np.random.RandomState(6).randint(0, 256, (24, 40)) \
        .astype(np.int32)
    stream = encode([frame], device='cpu', reversible=True, num_decomps=2,
                    block_size=(16, 16))
    trace.reset()
    trace.enable()
    try:
        vd = VideoDecoder(device='cpu', to_device=True)
        try:
            for _ in range(3):
                vd.submit([stream] * 2)
                vd.collect_on_device()
            vd.drain_errors()
        finally:
            vd.close()
    finally:
        trace.disable()
        stages = trace.get_stats()
        trace.reset()
    for stage in STAGES.values():
        assert stages[stage]['calls'] == 3
        assert stages[stage]['parents'] == ['decode.host_prep']
    assert stages['decode.t2.walk']['calls'] == 6
    assert 'decode.t2.packets' not in stages
    assert sum(stages[s]['seconds'] for s in STAGES.values()) <= \
        stages['decode.host_prep']['seconds']
    rec = _rec(stages, frames=6)
    for sfx in CELLS:
        assert metrics.reader(f'{SHARE}.{sfx}')(rec, {}) == 100.0
        for base in STAGES:
            assert metrics.reader(f'{base}.{sfx}')(rec, {}) > 0
