"""The port's stage timers and profiler hook (openjph_tpu_torch.utils.trace)
against the JAX package's (openjph_tpu.utils.trace): stages collected on
the port's paths (on the CPU), no-op when disabled, nesting, safety
across threads, message-level gating through the port's exported
setters, and stage-name parity: the same runs in both packages, traced,
give the port every stage name the JAX package gives.  Also the port's
own additions: parents and self time, recorded durations, bursts and
their tail attribution, collector pauses, the video decoder's burst
stages, and what a traced-off submit / collect round costs."""
import gc
import io
import json
import os
import sys
import threading
import time
import warnings

import numpy as np
import pytest
import torch

import openjph_tpu as oj
import openjph_tpu_torch as ot
from openjph_tpu.utils import trace as jax_trace
from openjph_tpu_torch.core import message as msg
from openjph_tpu_torch.utils import trace

# JAX stage names the port's runs need not give, each with its reason
# (none: the port times every stage the JAX package times)
PARITY_EXCEPTIONS = {}


@pytest.fixture(autouse=True)
def _reset():
    yield
    for t in (trace, jax_trace):
        t.disable()
        t.reset()
    msg.set_message_level(msg.INFO)
    msg.set_warning_stream(None)


def _img(shape=(40, 56), seed=0):
    return np.random.RandomState(seed).randint(0, 256, shape) \
        .astype(np.int32)


def test_stage_timers_collect_encode_decode():
    trace.enable()
    img = _img()
    s = ot.encode_gpu(img, device='cpu', reversible=True, num_decomps=2)
    assert np.array_equal(ot.decode_gpu(s, device='cpu')[0], img)
    st = trace.get_stats()
    for name in ('decode.plan', 'decode.host_prep', 'decode.compile',
                 'decode.device', 'decode.upload', 'decode.assemble',
                 'encode.plan', 'encode.compile', 'encode.device',
                 'encode.upload', 'encode.segment_pack', 'encode.pack.fetch',
                 'encode.t2'):
        assert st[name]['calls'] == 1, name
    # once per lane group
    assert st['encode.pack.stuff']['calls'] == \
        st['encode.pack.fill']['calls'] >= 1
    for v in st.values():
        assert v['calls'] >= 1 and v['seconds'] >= 0
    assert 'ms/call' in trace.report()
    buf = io.StringIO()
    assert trace.report(buf) + '\n' == buf.getvalue()


def test_stage_noop_when_disabled():
    assert not trace.is_enabled()
    with trace.stage('x'):
        pass
    ot.decode_gpu(ot.encode_gpu(_img((16, 16)), device='cpu',
                                num_decomps=1), device='cpu')
    assert trace.get_stats() == {}


def test_nested_stages():
    trace.enable()
    with trace.stage('outer'):
        with trace.stage('inner'):
            pass
    st = trace.get_stats()
    assert st['outer']['calls'] == 1 and st['inner']['calls'] == 1
    assert st['outer']['seconds'] >= st['inner']['seconds']


def test_stage_never_synchronises(monkeypatch):
    def boom(*a, **k):
        raise AssertionError('stage() synchronised the device')

    monkeypatch.setattr(torch.cuda, 'synchronize', boom)
    trace.enable()
    with trace.stage('x'):
        pass
    assert trace.get_stats()['x']['calls'] == 1


def test_stages_from_many_threads_lose_no_update():
    trace.enable()
    n_threads, n_calls = 16, 300
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(n_calls):
                with trace.stage('t'):
                    pass
        ts = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=30)
        assert not any(t.is_alive() for t in ts)
    finally:
        sys.setswitchinterval(old)
    assert trace.get_stats()['t']['calls'] == n_threads * n_calls


def test_message_level_suppresses_warnings():
    ot.set_message_level(msg.ERROR)
    buf = io.StringIO()
    ot.set_warning_stream(buf)
    with warnings.catch_warnings():
        warnings.simplefilter('error')  # any warning would raise
        img = np.zeros((64, 64), np.uint8)
        ot.encode(img, device='cpu', tileparts='C')  # RPCL+C warns 0x30021
    assert buf.getvalue() == ''
    with pytest.raises(ot.OjphError):
        msg.error(0x1, 'boom')


def test_port_exports_the_jax_packages_message_setters():
    for name in ('set_info_stream', 'set_warning_stream', 'set_error_stream',
                 'configure_info', 'configure_warning', 'configure_error',
                 'set_message_level', 'OjphError', 'OjphWarning', 'trace'):
        assert hasattr(ot, name) and hasattr(oj, name), name
    assert ot.trace is trace


def _runs(pkg, dev_kw):
    """One small encode and decode, a burst decode, and a 4-frame run of
    the video decoder and encoder (bursts of 2), through ``pkg``."""
    img = _img()
    enc = pkg.encode_gpu if dev_kw else pkg.encode_tpu
    dec = pkg.decode_gpu if dev_kw else pkg.decode_tpu
    batch = pkg.decode_gpu_batch if dev_kw else pkg.decode_tpu_batch
    s = enc(img, reversible=True, num_decomps=2, **dev_kw)
    dec(s, **dev_kw)
    batch([s] * 2, **dev_kw)
    vd = pkg.VideoDecoder(**dev_kw)
    ve = pkg.VideoEncoder(reversible=True, num_decomps=2, **dev_kw)
    for v, item in ((vd, s), (ve, img)):
        for _ in range(2):
            v.submit([item] * 2)
        while v.depth:
            v.collect()
    for v in (vd, ve):
        if hasattr(v, 'close'):
            v.close()


def test_stage_name_parity_with_the_jax_package():
    for t in (trace, jax_trace):
        t.reset()
        t.enable()
    _runs(oj, {})
    _runs(ot, {'device': 'cpu'})
    jax_names = set(jax_trace.get_stats())
    port_names = set(trace.get_stats())
    assert jax_names, 'the JAX runs gave no stage'
    missing = jax_names - port_names - set(PARITY_EXCEPTIONS)
    assert not missing, f'stages the port does not time: {sorted(missing)}'
    # the rest are JAX names of its other modes, or host steps the port
    # nests under a JAX name (PERF.md section 3)
    assert port_names - jax_names <= {
        'decode.upload', 'encode.upload', 'encode.pack.fetch',
        'encode.pack.stuff', 'encode.pack.fill', 'encode.dev.aux_fetch',
        'decode.fetch', 'decode.plan', 'decode.pack.grow',
        'host.gc'} | BURST_STAGES


def test_torch_trace_writes_a_chrome_trace(tmp_path):
    img = _img((16, 16))
    with trace.torch_trace(str(tmp_path), device='cpu', name='t') as prof:
        ot.encode_gpu(img, device='cpu', num_decomps=1)
    path = tmp_path / 't.json'
    assert path.exists()
    with open(path) as f:
        doc = json.load(f)
    events = doc['traceEvents'] if isinstance(doc, dict) else doc
    assert any(e.get('cat') == 'cpu_op' for e in events)
    assert len(prof.key_averages()) > 0
    assert os.listdir(tmp_path) == ['t.json']


def test_torch_trace_shows_the_stages_of_every_thread(tmp_path):
    """With tracing enabled, stages are profiler ranges; the video
    encoder's workers time theirs on threads of their own."""
    img = _img((32, 32)).astype(np.uint8)
    ve = ot.VideoEncoder(device='cpu', reversible=True, num_decomps=2)
    try:
        ve.submit([img] * 2)
        ve.collect()  # warm
        trace.enable()
        with trace.torch_trace(str(tmp_path), device='cpu', name='v'):
            ve.submit([img] * 2)
            ve.collect()
    finally:
        ve.close()
    with open(tmp_path / 'v.json') as f:
        events = json.load(f)['traceEvents']
    ranges = [e for e in events if e.get('cat') == 'user_annotation']
    names = {e['name'] for e in ranges}
    assert {'encode.host_prep', 'encode.device', 'encode.segment_pack',
            'encode.t2'} <= names
    assert len({e['tid'] for e in ranges}) >= 3


# the video decoder's burst stages that a CPU run records (the staging
# ring's slot wait and pinned allocations exist only on a CUDA device)
BURST_STAGES = {'decode.queue_wait', 'decode.collect_wait',
                'decode.dispatch.upload', 'decode.dispatch.tier1',
                'decode.dispatch.rest', 'decode.rest_graph.eager',
                'decode.burst', 'decode.host_prep.t2',
                'decode.host_prep.plan', 'decode.host_prep.pack',
                'decode.t2.walk'}
DISPATCH_PARTS = ('decode.dispatch.upload', 'decode.dispatch.tier1',
                  'decode.dispatch.rest')


def test_self_time_and_parents():
    trace.enable()
    with trace.stage('outer'):
        with trace.stage('inner'):
            time.sleep(0.02)
        with trace.stage('inner'):
            pass
    st = trace.get_stats()
    assert st['inner']['parents'] == ['outer']
    assert st['outer']['parents'] == []
    assert st['inner']['self_seconds'] == pytest.approx(
        st['inner']['seconds'])
    assert st['outer']['self_seconds'] == pytest.approx(
        st['outer']['seconds'] - st['inner']['seconds'])
    assert st['outer']['self_seconds'] >= 0


@pytest.mark.parametrize('to_device', [True, False])
def test_video_decoder_records_every_burst_stage(to_device):
    """Each burst's stages: every one of them recorded, the dispatch's
    three parts inside it, self times within totals, and a runner built
    on a cache miss counted under the burst that missed."""
    # a geometry no other test builds a runner for
    s = ot.encode_gpu(_img((24, 40 if to_device else 44), seed=3),
                      device='cpu', reversible=True, num_decomps=2)
    vd = ot.VideoDecoder(device='cpu', to_device=to_device)
    trace.enable()
    try:
        for _ in range(3):
            vd.submit([s] * 2)
        while vd.depth:
            (vd.collect_on_device if to_device else vd.collect)()
        vd.drain_errors()
    finally:
        vd.close()
    st = trace.get_stats()
    want = BURST_STAGES | {'decode.host_prep', 'decode.dispatch',
                           'decode.compile'}
    want |= {'decode.error_check'} if to_device else {'decode.fetch'}
    assert want <= set(st)
    for name in BURST_STAGES - {'decode.compile', 'decode.t2.walk'}:
        assert st[name]['calls'] == 3, name
    # a walk a tile-part: two frames of one tile-part a burst
    assert st['decode.t2.walk']['calls'] == 6
    assert st['decode.t2.walk']['parents'] == ['decode.host_prep.t2']
    for name in DISPATCH_PARTS:
        assert st[name]['parents'] == ['decode.dispatch']
    assert sum(st[n]['seconds'] for n in DISPATCH_PARTS) <= \
        st['decode.dispatch']['seconds']
    for name, v in st.items():
        assert 0 <= v['self_seconds'] <= v['seconds'] + 1e-9, name
    rows = list(trace._bursts)
    assert len(rows) == 3
    assert [('decode.compile' in r) for _, r in rows] == [True, False, False]
    for span, r in rows:
        assert r['decode.burst'] == span
        assert r['decode.dispatch'] <= span


@pytest.mark.parametrize('enabled', [True, False])
def test_collections_are_stages_while_enabled(enabled):
    """A collection is a leaf stage of the thread's innermost stage, and
    counts under a burst only when it ran inside one; a burst stage is
    a stage inside a burst only."""
    (trace.enable if enabled else trace.disable)()
    b = trace.open_burst('decode.burst')
    with trace.burst(b):
        with trace.stage('s'), trace.burst_stage('in'):
            gc.collect()
    trace.close_burst(b)
    with trace.burst_stage('out'):   # no burst: no stage
        gc.collect()                 # and a collection outside every burst
    st = trace.get_stats()
    if enabled:
        gcs = st['host.gc']
        assert gcs['calls'] >= 2 and gcs['parents'] == ['in']
        assert list(trace._bursts)[0][1]['host.gc'] == \
            gcs['burst_seconds'] < gcs['seconds']
        assert 'out' not in st and st['in']['parents'] == ['s']
        assert st['in']['self_seconds'] <= \
            st['in']['seconds'] - gcs['burst_seconds'] + 1e-9
    else:
        assert b is None and st == {}
    trace.disable()
    assert trace._on_gc not in gc.callbacks
    gc.collect()
    assert trace.get_stats() == st


def test_a_collection_open_at_disable_or_reset_is_dropped(monkeypatch):
    """A collection whose stop the hook missed (removed by a disable()
    in between) or that straddles a reset() records nothing, and no
    later stage counts as its child."""
    clock = [0.0]
    monkeypatch.setattr(trace.time, 'perf_counter', lambda: clock[0])
    was = gc.isenabled()
    gc.disable()   # only the collections this test makes
    try:
        trace.enable()
        trace._on_gc('start', {})
        clock[0] += 5.0
        trace.disable()          # its stop never reaches the hook
        trace.enable()
        with trace.stage('after'):
            clock[0] += 1.0
        trace._on_gc('start', {})
        clock[0] += 2.0
        trace._on_gc('stop', {})
        st = trace.get_stats()
        trace._on_gc('start', {})
        trace.reset()
        trace._on_gc('stop', {})
    finally:
        if was:
            gc.enable()
    assert st['host.gc']['calls'] == 1
    assert st['host.gc']['seconds'] == 2.0
    assert st['after']['parents'] == []
    assert st['after']['self_seconds'] == 1.0
    assert trace.get_stats() == {}


def _bursts(spans, fake_clock, per_burst=None):
    """One burst a span (seconds on ``fake_clock``), each with stage
    ``x`` of ``per_burst(i)`` seconds recorded under it."""
    for i, span in enumerate(spans):
        b = trace.open_burst('decode.burst')
        with trace.burst(b):
            trace.add('x', per_burst(i) if per_burst else 0.0)
        fake_clock[0] += span
        trace.close_burst(b)


def test_tail_seconds_are_the_slowest_bursts(monkeypatch):
    """Spans 1..100 s: the 95th percentile is 95.05, so the tail is the
    bursts of 96..100 s; stage x took i s in the burst of i + 1 s."""
    clock = [0.0]
    monkeypatch.setattr(trace.time, 'perf_counter', lambda: clock[0])
    trace.enable()
    _bursts(list(range(1, 20)), clock)
    assert 'tail_seconds' not in trace.get_stats()['decode.burst']
    trace.reset()
    order = np.random.RandomState(0).permutation(100)
    _bursts([i + 1.0 for i in order], clock, lambda k: float(order[k]))
    st = trace.get_stats()
    assert st['decode.burst']['tail_seconds'] == pytest.approx(98.0)
    assert st['x']['tail_seconds'] == pytest.approx(97.0)
    assert st['decode.burst']['calls'] == st['x']['calls'] == 100
    trace.reset()
    assert trace.get_stats() == {} and len(trace._bursts) == 0
    _bursts([1.0], clock)
    assert 'tail_seconds' not in trace.get_stats()['decode.burst']


def test_burst_table_is_bounded():
    trace.enable()
    for _ in range(trace.BURST_ROWS + 5):
        trace.close_burst(trace.open_burst('decode.burst'))
    assert len(trace._bursts) == trace.BURST_ROWS
    assert trace.get_stats()['decode.burst']['calls'] == \
        trace.BURST_ROWS + 5


def test_bursts_from_many_threads_lose_no_update():
    trace.enable()
    n_threads, n_bursts = 16, 100
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(n_bursts):
                b = trace.open_burst('decode.burst')
                with trace.burst(b):
                    with trace.stage('t'):
                        trace.add('w', 1.0)
                trace.close_burst(b)
        ts = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in ts)
    finally:
        sys.setswitchinterval(old)
    st = trace.get_stats()
    n = n_threads * n_bursts
    assert st['t']['calls'] == st['w']['calls'] == \
        st['decode.burst']['calls'] == n
    assert st['w']['seconds'] == n
    assert [r['w'] for _, r in trace._bursts] == [1.0] * n
    assert st['w']['tail_seconds'] == 1.0


def test_traced_off_round_costs_one_branch_a_site(monkeypatch):
    """With tracing off a submit / collect round of the video decoder
    reads no clock, opens no range, records nothing and leaves no
    collector hook."""
    s = ot.encode_gpu(_img((16, 16)), device='cpu', num_decomps=1)
    vd = ot.VideoDecoder(device='cpu', to_device=True)
    try:
        vd.submit([s])
        vd.collect_on_device()   # warm: the runner is built
        calls = []
        real = time.perf_counter

        def counting():
            # the port's reads only: other threads of the process may
            # keep their own time
            caller = sys._getframe(1).f_globals.get('__name__', '')
            if caller.startswith('openjph_tpu_torch'):
                calls.append(caller)
            return real()

        def no_range(*a, **k):
            raise AssertionError('a range opened with tracing off')

        monkeypatch.setattr(time, 'perf_counter', counting)
        monkeypatch.setattr(trace, 'record_function', no_range)
        for _ in range(2):
            vd.submit([s] * 2)
        assert all(b is None for _, b in vd._inflight)
        while vd.depth:
            vd.collect_on_device()
        vd.drain_errors()
    finally:
        vd.close()
    assert calls == []
    assert trace.get_stats() == {} and len(trace._bursts) == 0
    assert trace._on_gc not in gc.callbacks
