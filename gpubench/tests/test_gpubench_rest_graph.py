"""The reader of ``decode.rest_graph_share``: on hand-built records, the
share of the rest of graph's dispatches that replayed a graph captured
before them (a capture in the window counts against it), 0.0 where every
dispatch ran eagerly, None for an untraced run, a program without burst
spans or one whose rest of graph records no ``decode.rest_graph.*``
stage; each such entry of BENCHMARK.json has its reader and its cell; the
stages of a traced CPU decode (every dispatch eager) read 0.0.  The
traced runs of the whole cells are ``test_gpubench_spans.py``'s."""
import numpy as np
import pytest

from gpubench.harness import manifest, metrics
from gpubench.harness.cell import Record
from gpubench.loops.closed import LoopRecord

BASE = 'decode.rest_graph_share'
CELLS = {'stream': ('decode_mpix_s', 'gray8_2k_rev53.decode_stream'),
         'frame': ('decode_frame_p95_ms', 'rgb8_2k_97ict.decode_frame')}


def _rec(stages):
    return Record(config={}, traffic={'burst': 1}, seconds=2.0, setup_s=1.0,
                  loop=LoopRecord(window_s=2.0, frames=40), mpix=2.2,
                  stages=stages)


def _calls(n):
    return {'seconds': 0.01 * n, 'calls': n, 'ms_per_call': 10.0,
            'self_seconds': 0.01 * n, 'parents': [], 'burst_seconds': 0.0}


@pytest.mark.parametrize('sfx', sorted(CELLS))
def test_reader(sfx):
    read = metrics.reader(f'{BASE}.{sfx}')
    burst = {'decode.burst': _calls(40), 'decode.dispatch.rest': _calls(40)}
    replayed = dict(burst, **{'decode.rest_graph.replay': _calls(30),
                              'decode.rest_graph.eager': _calls(10)})
    assert read(_rec(replayed), {}) == pytest.approx(75.0)
    assert read(_rec(dict(burst, **{
        'decode.rest_graph.replay': _calls(40)})), {}) == 100.0
    # a capture in the window: its call replays, but not a graph made
    # before the window
    assert read(_rec(dict(burst, **{
        'decode.rest_graph.eager': _calls(1),
        'decode.rest_graph.capture': _calls(1),
        'decode.rest_graph.replay': _calls(39)})), {}) == pytest.approx(95.0)
    # every dispatch eager (the CPU, or failed captures): 0
    assert read(_rec(dict(burst, **{
        'decode.rest_graph.eager': _calls(40)})), {}) == 0.0
    # untraced; no burst span; a program without the graph's stages
    assert read(_rec(None), {}) is None
    assert read(_rec({'decode.dispatch.rest': _calls(40),
                      'decode.rest_graph.replay': _calls(40)}), {}) is None
    assert read(_rec(burst), {}) is None


def test_entries_have_their_reader_and_cell():
    entries = {m['name']: m for m in manifest.load()['per_layer']
               if m['name'].rsplit('.', 1)[0] == BASE}
    assert sorted(entries) == [f'{BASE}.{s}' for s in ('frame', 'stream')]
    for name, m in entries.items():
        sfx = name.rsplit('.', 1)[1]
        assert metrics.reader_path(name).endswith(f'/{BASE}.py')
        assert (m['unit'], m['better'], m['source']) == (
            '%', 'higher', 'program_counter')
        assert m['layer'].startswith('decode dispatch:')
        assert (m['moves'], m['workloads']) == (CELLS[sfx][0],
                                                [CELLS[sfx][1]])


@pytest.mark.parametrize('sfx', sorted(CELLS))
def test_traced_cpu_decode_reads_zero(sfx):
    """A traced VideoDecoder on the CPU, where the rest of graph always
    runs eagerly: its stages read 0.0."""
    from openjph_tpu_torch import VideoDecoder, encode, trace
    frame = np.random.RandomState(5).randint(0, 256, (24, 32)) \
        .astype(np.int32)
    stream = encode([frame], device='cpu', reversible=True, num_decomps=2,
                    block_size=(16, 16))
    trace.reset()
    trace.enable()
    try:
        vd = VideoDecoder(device='cpu', to_device=True)
        try:
            for _ in range(3):
                vd.submit([stream])
                vd.collect_on_device()
            vd.drain_errors()
        finally:
            vd.close()
    finally:
        trace.disable()
        stages = trace.get_stats()
        trace.reset()
    assert metrics.reader(f'{BASE}.{sfx}')(_rec(stages), {}) == 0.0
