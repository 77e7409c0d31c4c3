"""The rest of graph's CUDA graph (gpu/pipeline.py ``_Runner.rest``,
``_RestGraph``) on the CPU.

- Capturable: run on the meta device under a ``TorchDispatchMode``,
  ``_Runner.rest`` issues no op that waits for the device or moves data
  between the host and the device (a scalar read, ``nonzero``, a copy to
  or from host memory) for every kind of plan: gray 5/3, RGB 9/7 ICT,
  several tiles, Part-2 DFS, 64-bit groups, an int64 (``host_out``)
  burst, a skipped resolution and a resilient burst with broken lanes.
  Host 0-dim constants may only enter elementwise arithmetic, which
  passes them to the kernel as scalars.
- On the CPU every call runs eagerly and records
  ``decode.rest_graph.eager``, never a capture or a replay.
- The capture policy, with the graph stubbed: a key's first sighting
  eager, captured on the second, replayed from then on, once across
  threads; one graph for every runner of a geometry (raw and dense, any
  word buckets), none for a runner made for one call; a capture that
  raises leaves the key eager, with a warning and its error kept; graphs
  past the pool budget or keys past the cache's size go out least
  recently used first.
"""
import functools
import os
import threading

import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode

from openjph_tpu import codec
from openjph_tpu.core import markers as mk
from openjph_tpu.core.markers import Dfs

import openjph_tpu_torch
from openjph_tpu_torch import trace
from openjph_tpu_torch.core import message as msg
from openjph_tpu_torch.gpu import pipeline as tp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TESTDATA = os.path.join(REPO, 'openjph_tpu_torch', 'testdata')

# ops that read a device value on the host
SYNCS = {'_local_scalar_dense', 'item', 'nonzero', 'is_nonzero', 'equal',
         'allclose', 'masked_select', 'unique', '_unique', '_unique2',
         'unique_consecutive', 'unique_dim'}
# elementwise ops that take a host 0-dim tensor as a kernel scalar
HOST_SCALAR_OK = {'mul', 'add', 'sub', 'div'}


def _img(seed, h, w, top=256):
    return np.random.RandomState(seed).randint(0, top, (h, w)) \
        .astype(np.int32)


def _encode(planes, **kw):
    return openjph_tpu_torch.encode(planes, device='cpu', **kw)


def _dfs():
    siz = mk.Siz()
    siz.xsiz, siz.ysiz = 32, 32
    siz.comps = [mk.CompInfo(8, False, 1, 1)]
    dfs = Dfs.from_types(0, [Dfs.HORZ_DWT, Dfs.VERT_DWT, Dfs.BIDIR_DWT])
    cod = mk.Cod(num_decomps=3, wavelet_kern=mk.DWT_REV53)
    cocs = {0: mk.Cod(num_decomps=3, wavelet_kern=mk.DWT_REV53,
                      comp_idx=0, dfs_idx=0)}
    return codec.Encoder(siz, cod, cocs=cocs, dfs_list=[dfs]).encode(
        [_img(7, 32, 32)])


def _fixture(name):
    with open(os.path.join(TESTDATA, name), 'rb') as f:
        return f.read()


_GRAY = functools.lru_cache(None)(lambda: _encode(
    [_img(1, 48, 64)], reversible=True, num_decomps=3, block_size=(16, 16)))

# name -> (streams of a burst, decoder keywords)
PLANS = {
    'gray_53': (lambda: [_GRAY()], {}),
    'rgb_97_ict': (lambda: [_encode([_img(2 + c, 40, 56) for c in range(3)],
                                    reversible=False, num_decomps=2,
                                    block_size=(16, 16))], {}),
    'tiles': (lambda: [_encode([_img(3, 64, 80)], reversible=True,
                               num_decomps=2, tile_size=(32, 32),
                               block_size=(16, 16))], {}),
    'dfs': (lambda: [_dfs()], {}),
    'wide_64': (lambda: [_fixture('wide_gray_u29_l5.j2c')], {}),
    'host_out_burst': (lambda: [_fixture('wide_rgb_u32_rct_l5.j2c')] * 2,
                       {}),
    'skip_res_1': (lambda: [_GRAY()], {'skip_res': 1}),
    'resilient_broken': (lambda: [_GRAY()] * 2,
                         {'resilient': True, 'broken': True}),
}


class _HostTraffic(TorchDispatchMode):
    """Records the ops that would wait for the device or copy between it
    and the host, when the tensors live on a device."""

    def __init__(self):
        super().__init__()
        self.bad = []
        self.ops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        self.ops += 1
        name = func.overloadpacket.__name__
        ins = [a for a in pytree.tree_leaves((args, kwargs))
               if isinstance(a, torch.Tensor) and a.device.type == 'cpu']
        outs = [o for o in pytree.tree_leaves(out)
                if isinstance(o, torch.Tensor) and o.device.type == 'cpu']
        if name in SYNCS:
            self.bad.append(name)
        elif name == 'lift_fresh':
            pass    # a host constant made by torch.tensor
        elif outs or (ins and not (name in HOST_SCALAR_OK and
                                   all(a.dim() == 0 for a in ins))):
            self.bad.append(f'{name} with host tensors')
        return out


@pytest.fixture(autouse=True)
def _quiet():
    old = msg._level
    msg.set_message_level(msg.NO_MSG)
    yield
    msg._level = old


def _break_a_lane(dec):
    """Give the first live codeblock of ``dec``'s Tier-2 parse a
    length the host decoder rejects (lcup < 2)."""
    for st in dec.tiles:
        for recs in st.rec.values():
            for rb, _ in recs.values():
                for i in range(rb.shape[0]):
                    if rb[i, 4] and rb[i, 1] and rb[i, 2] and rb[i, 5]:
                        rb[i, 2] = 1
                        return
    raise AssertionError('no live codeblock')


def _burst(streams, skip_res=0, resilient=False, broken=False):
    decs = tp._decoders(streams, 'cpu', True, resilient, skip_res)
    if broken:
        _break_a_lane(decs[0])
    plans = tp._burst_plans(decs)
    assert plans is not None
    return decs, plans


@pytest.mark.parametrize('name', list(PLANS))
def test_rest_issues_no_host_traffic(name):
    make, kw = PLANS[name]
    _, plans = _burst(make(), **kw)
    plan = plans[0]
    if name == 'wide_64':
        assert any(g.bits == 64 for g in plan.groups)
    if name == 'host_out_burst':
        assert all(len(t) == 4 for t in plan.tiles)  # host_out set
    if name == 'resilient_broken':
        assert sum(p.broken for p in plans) > 0
    meta = torch.device('meta')
    runner = tp._Runner(plan, len(plans), meta, True)
    decs = [torch.zeros((len(plans), g.n_pad, g.h, g.w), device=meta,
                        dtype=torch.int64 if g.bits == 64 else torch.int32)
            for g in plan.groups]
    mode = _HostTraffic()
    with mode:
        outs = runner.rest(decs)
    assert mode.ops > 0 and mode.bad == []
    assert all(c.device == meta for t in outs for c in t)


@pytest.fixture
def traced():
    trace.reset()
    trace.enable()
    yield
    trace.disable()
    trace.reset()


def test_cpu_calls_stay_eager(traced):
    vd = openjph_tpu_torch.VideoDecoder(device='cpu', to_device=True)
    try:
        for _ in range(3):
            vd.submit([_GRAY()] * 2)
            vd.collect_on_device()
        vd.drain_errors()
    finally:
        vd.close()
    st = trace.get_stats()
    assert st['decode.rest_graph.eager']['calls'] == 3
    assert st['decode.rest_graph.eager']['parents'] == ['decode.dispatch.rest']
    assert st['decode.dispatch.rest']['calls'] == 3
    assert 'decode.rest_graph.capture' not in st
    assert 'decode.rest_graph.replay' not in st
    runner = tp._burst_runner(tp._burst_plans(tp._decoders(
        [_GRAY()] * 2, 'cpu', True, False, 0))[0], 2, torch.device('cpu'),
        True)
    assert runner.graphs and runner.rest_key not in tp._REST_GRAPHS._entries


class _StubGraph:
    """Stands in for the CUDA graph on the CPU: a capture records the
    ops' inputs, a replay runs the ops on them; each holds ``NBYTES``
    against a budget of ``BUDGET``."""
    made = []
    fail = False
    NBYTES = 100
    BUDGET = 1 << 40

    @staticmethod
    def supported(device):
        return True

    @classmethod
    def budget(cls, device):
        return cls.BUDGET

    def __init__(self, ops, decs, device):
        if self.fail:
            raise RuntimeError('capture refused')
        self.ops = ops
        self.ins = [torch.empty_like(d) for d in decs]
        self.replays = 0
        self.closed = False
        self.nbytes = self.NBYTES
        _StubGraph.made.append(self)

    def replay(self, decs):
        self.replays += 1
        for s, d in zip(self.ins, decs):
            s.copy_(d)
        return self.ops(self.ins)

    def close(self):
        self.closed = True


@pytest.fixture
def stub(monkeypatch):
    monkeypatch.setattr(tp, '_RestGraph', _StubGraph)
    monkeypatch.setattr(tp, '_REST_GRAPHS', tp._RestGraphs(64))
    monkeypatch.setattr(_StubGraph, 'made', [])
    monkeypatch.setattr(_StubGraph, 'fail', False)
    return _StubGraph


def _runner_and_decs(frames=1, raw=True, graphs=True, top=256):
    streams = [_encode([_img(1, 48, 64, top)], reversible=True,
                       num_decomps=3, block_size=(16, 16))] * frames
    decs, plans = _burst(streams)
    runner = tp._make_runner(plans[0], frames, 'cpu', raw, graphs)
    args = tp.upload(tp._pack(list(zip(decs, plans)), raw), 'cpu')
    return runner, runner.tier1(*args)[0]


def _same(a, b):
    return all(torch.equal(x, y) for s, t in zip(a, b) for x, y in zip(s, t))


def _entry(runner):
    return tp._REST_GRAPHS._entries.get(runner.rest_key)


def test_eager_then_capture_then_replay(stub, traced):
    runner, decs = _runner_and_decs()
    want = runner._ops(decs)
    assert _same(runner.rest(decs), want) and stub.made == []
    assert _same(runner.rest(decs), want)
    assert len(stub.made) == 1 and stub.made[0].replays == 1
    for _ in range(3):
        assert _same(runner.rest(decs), want)
    assert len(stub.made) == 1 and stub.made[0].replays == 4
    assert _entry(runner).graph is stub.made[0]
    st = trace.get_stats()
    assert [st[f'decode.rest_graph.{k}']['calls']
            for k in ('eager', 'capture', 'replay')] == [1, 1, 4]


def test_one_capture_across_threads(stub):
    runner, decs = _runner_and_decs()
    barrier = threading.Barrier(6)

    def call():
        barrier.wait()
        for _ in range(3):
            runner.rest(decs)

    threads = [threading.Thread(target=call) for _ in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert _entry(runner).calls == 18
    assert len(stub.made) == 1 and stub.made[0].replays == 17


def test_runners_of_one_geometry_share_a_graph(stub):
    """A raw and a dense runner, and a runner of flatter content whose
    word buckets are smaller, are three runners of one key: the second
    sighting captures, whichever runner makes it."""
    raw, decs = _runner_and_decs(raw=True)
    dense, decs_d = _runner_and_decs(raw=False)
    other, decs_o = _runner_and_decs(top=4)
    assert raw.raw != dense.raw
    assert raw.plan.key != other.plan.key
    assert raw.rest_key == dense.rest_key == other.rest_key
    assert _same(raw.rest(decs), raw._ops(decs)) and stub.made == []
    assert _same(dense.rest(decs_d), dense._ops(decs_d))
    assert _same(other.rest(decs_o), other._ops(decs_o))
    assert len(stub.made) == 1 and stub.made[0].replays == 2
    # another frame count is another key
    two, decs_2 = _runner_and_decs(frames=2)
    assert two.rest_key != raw.rest_key
    two.rest(decs_2)
    assert len(stub.made) == 1


def test_a_runner_for_one_call_stays_eager(stub, traced):
    runner, decs = _runner_and_decs(graphs=False)
    for _ in range(3):
        assert _same(runner.rest(decs), runner._ops(decs))
    assert stub.made == [] and _entry(runner) is None
    assert trace.get_stats()['decode.rest_graph.eager']['calls'] == 3


def test_failed_capture_stays_eager(stub, traced):
    stub.fail = True
    runner, decs = _runner_and_decs()
    want = runner._ops(decs)
    assert _same(runner.rest(decs), want)
    with pytest.warns(RuntimeWarning, match='stays eager'):
        assert _same(runner.rest(decs), want)
    assert _same(runner.rest(decs), want)
    assert isinstance(_entry(runner).error, RuntimeError)
    assert _entry(runner).graph is None
    st = trace.get_stats()
    assert st['decode.rest_graph.capture']['calls'] == 1
    assert st['decode.rest_graph.eager']['calls'] == 3
    assert 'decode.rest_graph.replay' not in st


def test_graphs_past_the_budget_go_least_recent_first(stub, monkeypatch):
    """Three keys' graphs of 100 bytes under a budget of 250: the third
    capture drops the least recently replayed graph, whose key then
    starts again eager."""
    monkeypatch.setattr(_StubGraph, 'BUDGET', 250)
    runners = [_runner_and_decs(frames=f) for f in (1, 2, 4)]
    for r, d in runners[:2]:
        r.rest(d)
        r.rest(d)
    runners[0][0].rest(runners[0][1])   # key 1 now the most recent
    r4, d4 = runners[2]
    r4.rest(d4)
    r4.rest(d4)
    g1, g2, g4 = stub.made
    assert (g1.closed, g2.closed, g4.closed) == (False, True, False)
    assert _entry(runners[1][0]) is None
    assert _entry(runners[0][0]).graph is g1 and _entry(r4).graph is g4
    r2, d2 = runners[1]
    assert _same(r2.rest(d2), r2._ops(d2)) and len(stub.made) == 3
    assert _entry(r2).calls == 1


def test_keys_past_the_size_go_least_recent_first(stub, monkeypatch):
    monkeypatch.setattr(tp, '_REST_GRAPHS', tp._RestGraphs(2))
    runners = [_runner_and_decs(frames=f) for f in (1, 2, 4)]
    r1, d1 = runners[0]
    r1.rest(d1)
    r1.rest(d1)
    for r, d in runners[1:]:
        r.rest(d)
    assert _entry(r1) is None and stub.made[0].closed
    assert [_entry(r).calls for r, _ in runners[1:]] == [1, 1]
