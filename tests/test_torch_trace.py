"""The port's stage timers and profiler hook (openjph_tpu_torch.utils.trace)
against the JAX package's (openjph_tpu.utils.trace): stages collected on
the port's paths (on the CPU), no-op when disabled, nesting, safety
across threads, message-level gating through the port's exported
setters, and stage-name parity: the same runs in both packages, traced,
give the port every stage name the JAX package gives."""
import io
import json
import os
import sys
import threading
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
        'decode.fetch', 'decode.plan'}


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
