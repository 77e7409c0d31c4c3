"""The reader of ``decode.pack_reuse_share`` (raw packs that wrote into
the video decoder's host buffer without growing it, over all raw packs,
in %) on hand-built records: None for an untraced run, a program without
burst spans and one without the pack stage; 100 for a program that
records packs and no growth (a port older than the growth stage); its
two entries of BENCHMARK.json have their reader and cell; a
traced CPU VideoDecoder reads 100 once its first burst has grown the
buffer, as the harness's warm-up does before the window."""
import numpy as np
import pytest

from gpubench.harness import manifest, metrics
from gpubench.harness.cell import Record
from gpubench.loops.closed import LoopRecord

NAME = 'decode.pack_reuse_share'
PACK, GROW = 'decode.host_prep.pack', 'decode.pack.grow'
CELLS = {'stream': ('decode_mpix_s', 'gray8_2k_rev53.decode_stream'),
         'frame': ('decode_frame_p95_ms', 'rgb8_2k_97ict.decode_frame')}
LAYER = ('decode host front: Tier-2, plan and pack (codec.Decoder, '
         'core.t2, gpu.pipeline._build_plan / _pack)')


def _rec(stages):
    return Record(config={}, traffic={'burst': 1}, seconds=2.0, setup_s=1.0,
                  loop=LoopRecord(window_s=2.0, frames=40), mpix=2.2,
                  stages=stages)


def _calls(n):
    return {'seconds': 0.01 * n, 'calls': n, 'ms_per_call': 10.0,
            'self_seconds': 0.01 * n, 'parents': [],
            'burst_seconds': 0.01 * n}


@pytest.mark.parametrize('sfx', sorted(CELLS))
def test_reuse_share_reader(sfx):
    read = metrics.reader(f'{NAME}.{sfx}')
    burst = {'decode.burst': _calls(40)}
    assert read(_rec(dict(burst, **{PACK: _calls(40)})), {}) == 100.0
    assert read(_rec(dict(burst, **{PACK: _calls(40), GROW: _calls(10)})),
                {}) == pytest.approx(75.0)
    assert read(_rec(dict(burst, **{PACK: _calls(4), GROW: _calls(4)})),
                {}) == 0.0
    # untraced; no burst span; a program without the pack stage
    assert read(_rec(None), {}) is None
    assert read(_rec({PACK: _calls(40)}), {}) is None
    assert read(_rec(dict(burst, **{'decode.host_prep': _calls(40)})),
                {}) is None


def test_entries_have_their_reader_and_cell():
    entries = {m['name']: m for m in manifest.load()['per_layer']
               if m['name'].rsplit('.', 1)[0] == NAME}
    assert sorted(entries) == sorted(f'{NAME}.{s}' for s in CELLS)
    for name, m in entries.items():
        sfx = name.rsplit('.', 1)[1]
        assert metrics.reader_path(name).endswith(f'/{NAME}.py')
        assert (m['unit'], m['better'], m['source']) == \
            ('%', 'higher', 'program_counter')
        assert m['layer'] == LAYER
        assert (m['moves'], m['workloads']) == (CELLS[sfx][0],
                                                [CELLS[sfx][1]])


def test_traced_cpu_bursts_reuse_the_pack_buffer():
    """A traced VideoDecoder on the CPU, its first burst before the
    window: every later raw pack writes into the buffer as it stands."""
    from openjph_tpu_torch import VideoDecoder, encode, trace
    frame = np.random.RandomState(7).randint(0, 256, (24, 40)) \
        .astype(np.int32)
    stream = encode([frame], device='cpu', reversible=True, num_decomps=2,
                    block_size=(16, 16))
    trace.reset()
    trace.enable()
    try:
        vd = VideoDecoder(device='cpu', to_device=True)
        try:
            for k in range(4):
                if k == 1:
                    assert trace.get_stats()[GROW]['calls'] == 1
                    trace.reset()
                vd.submit([stream] * 2)
                vd.collect_on_device()
            vd.drain_errors()
        finally:
            vd.close()
    finally:
        trace.disable()
        stages = trace.get_stats()
        trace.reset()
    assert stages[PACK]['calls'] == 3 and GROW not in stages
    for sfx in CELLS:
        assert metrics.reader(f'{NAME}.{sfx}')(_rec(stages), {}) == 100.0
