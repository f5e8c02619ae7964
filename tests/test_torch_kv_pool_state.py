"""Port's ``PagedKVPool`` state round-trip against the reference's
(``tests/test_kv_pool_state.py``, the single-pool machine): a hypothesis
state machine drives a port pool and a JAX pool in lockstep through
random ``alloc`` / ``free`` / ``invalidate`` / ``write`` / ``step`` /
``migrate_tiers`` sequences, flat and tiered, over every hint scope
family, and after every rule both pools' block tables, host placement,
billing and tier stats are equal and their tensors agree within the
kernel tolerances (a scale to rtol 1e-6, an int8 code to 1 LSB, as
``tests/test_torch_kv_pool.py``). The ``snapshot_roundtrip`` rule is the
reference's: flush the dirty blocks through the billed path (on both
pools: equal reports and billing), capture ``snapshot_state()``, mutate
through public ops, ``load_state()`` back and require every mutable
field to come back bit for bit — with the tier tensors written in place,
the same objects as before. ``flush_dirty`` is also held against the
reference under a fault injector: the transient-retry draws, the
degraded link, the checksum stamps and the ``"flush"`` trace site."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# tiny shapes: PyTorch's intra-op threads would only spin beside the
# other test workers
torch.set_num_threads(1)
pytest.importorskip("hypothesis")
import hypothesis.strategies as st  # noqa: E402
from hypothesis import settings  # noqa: E402
from hypothesis.stateful import (RuleBasedStateMachine, initialize,  # noqa: E402
                                 invariant, rule, run_state_machine_as_test)
import jax.numpy as jnp  # noqa: E402

from repro.core import faults as jfaults  # noqa: E402
from repro.core.hints import HintTree as JHintTree  # noqa: E402
from repro.core.hints import MemoryHint as JMemoryHint  # noqa: E402
from repro.serve.kv_pool import PagedKVPool as JPool  # noqa: E402
from repro.serve.trace import Tracer as JTracer  # noqa: E402
from repro_torch.core import faults as tfaults  # noqa: E402
from repro_torch.core.hints import HintTree, MemoryHint  # noqa: E402
from repro_torch.serve.kv_pool import PagedKVPool  # noqa: E402
from repro_torch.serve.trace import Tracer  # noqa: E402

N_BLOCKS = 16
HBM = 4
SHAPE = (4, 16)

SCOPES = ["/t/mix", "/t/read", "/t/write", "/t/withdrawn"]


def _tree(tree_cls, hint_cls):
    t = tree_cls()
    t.set("/t/mix", hint_cls(read_fraction=0.5))
    t.set("/t/read", hint_cls(read_fraction=0.95))
    t.set("/t/write", hint_cls(read_fraction=0.05))
    t.set("/t/withdrawn", hint_cls(read_fraction=0.5, duplex_opt_in=False))
    return t


def _assert_state_equal(a, b, path=""):
    """Recursive bit-for-bit equality over snapshot_state() trees."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b), path
        for k in a:
            _assert_state_equal(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_state_equal(x, y, f"{path}[{i}]")
    elif isinstance(a, torch.Tensor):
        assert isinstance(b, torch.Tensor) and a.dtype == b.dtype, path
        assert torch.equal(a, b), path
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        assert np.array_equal(np.asarray(a), np.asarray(b)), path
    else:
        assert a == b, path


def _check_pair(t, j):
    """The port pool against the reference pool: host state exact,
    tensors within the kernel tolerances."""
    assert t.stats == j.stats
    assert t.tier_stats() == j.tier_stats()
    for name in ("slot_of", "block_at", "last_use", "_dirty", "_has_host",
                 "_allocated"):
        np.testing.assert_array_equal(getattr(t, name), getattr(j, name),
                                      err_msg=name)
    for name in ("slot_of", "block_of", "pref"):
        np.testing.assert_array_equal(getattr(t.host, name),
                                      getattr(j.host, name), err_msg=name)
    assert t.host._free == [list(f) for f in j.host._free]
    jq, tq = np.asarray(j.host_q, np.int32), t.host_q.numpy()
    js, ts = np.asarray(j.host_scale), t.host_scale.numpy()
    np.testing.assert_allclose(ts, js, rtol=1e-6)
    assert np.abs(tq - jq).max() <= 1
    jh, th = np.asarray(j.hbm, np.float32), t.hbm.float().numpy()
    step = float(np.max(js))
    assert np.all(np.abs(th - jh) <= step + np.abs(jh) * 2.0 ** -7)


class PoolPair(RuleBasedStateMachine):
    @initialize(tiers=st.sampled_from(
        [None, "ddr5:1,cxl:1", "cxl:2", "ddr5:2,cxl:2"]))
    def setup(self, tiers):
        self.pool = PagedKVPool(N_BLOCKS, HBM, SHAPE,
                                hints=_tree(HintTree, MemoryHint),
                                tiers=tiers, device="cpu")
        self.ref = JPool(N_BLOCKS, HBM, SHAPE,
                         hints=_tree(JHintTree, JMemoryHint), tiers=tiers)

    def _pick(self, seed: int, pop: np.ndarray, k: int) -> list[int]:
        if pop.size == 0 or k <= 0:
            return []
        rng = np.random.default_rng(seed)
        k = min(k, pop.size)
        return rng.choice(pop, size=k, replace=False).tolist()

    @rule(k=st.integers(1, 3))
    def alloc(self, k):
        free = int((~self.pool._allocated).sum())
        if free >= k:
            assert self.pool.alloc(k) == self.ref.alloc(k)

    @rule(seed=st.integers(0, 2**31 - 1), k=st.integers(1, 4))
    def free(self, seed, k):
        ids = self._pick(seed, np.flatnonzero(self.pool._allocated), k)
        self.pool.free(ids)
        self.ref.free(ids)

    @rule(seed=st.integers(0, 2**31 - 1), k=st.integers(1, 3))
    def invalidate(self, seed, k):
        ids = self._pick(seed, np.flatnonzero(self.pool._allocated), k)
        self.pool.invalidate(ids)
        self.ref.invalidate(ids)

    @rule(seed=st.integers(0, 2**31 - 1), k=st.integers(1, HBM),
          scope=st.sampled_from(SCOPES))
    def step(self, seed, k, scope):
        ids = self._pick(seed, np.flatnonzero(self.pool._allocated), k)
        if ids:
            assert self.pool.step(ids, hint_path=scope) == \
                self.ref.step(ids, hint_path=scope)

    @rule(seed=st.integers(0, 2**31 - 1), k=st.integers(1, HBM))
    def write_resident(self, seed, k):
        ids = self._pick(seed, self.pool.resident_blocks(), k)
        if ids:
            data = np.random.default_rng(seed).standard_normal(
                (len(ids),) + SHAPE).astype(np.float32)
            self.pool.write(np.asarray(ids, np.int32),
                            torch.from_numpy(data))
            self.ref.write(np.asarray(ids, np.int32), jnp.asarray(data))

    @rule()
    def migrate(self):
        assert self.pool.migrate_tiers() == self.ref.migrate_tiers()

    @rule(seed=st.integers(0, 2**31 - 1))
    def snapshot_roundtrip(self, seed):
        assert self.pool.flush_dirty() == self.ref.flush_dirty()
        _check_pair(self.pool, self.ref)
        snap = self.pool.snapshot_state()
        tensors = (self.pool.hbm, self.pool.host_q, self.pool.host_scale)
        ids = self._pick(seed, np.flatnonzero(self.pool._allocated), 2)
        if ids:
            self.pool.step(ids, hint_path="/t/mix")
            self.pool.free(ids[:1])
        if int((~self.pool._allocated).sum()) > 0:
            self.pool.alloc(1)
        self.pool.load_state(snap)
        _assert_state_equal(snap, self.pool.snapshot_state())
        assert all(a is b for a, b in zip(tensors, (
            self.pool.hbm, self.pool.host_q, self.pool.host_scale)))

    @invariant()
    def pools_agree(self):
        if not hasattr(self, "pool"):
            return
        self.pool.check_invariants()
        _check_pair(self.pool, self.ref)
        p = self.pool
        assert len(p.resident_blocks()) <= p.hbm_capacity
        assert not (p._dirty & ~p._allocated).any()
        assert not (p._has_host & ~p._allocated).any()
        if p.tiered:
            placed = np.flatnonzero(p.host.slot_of >= 0)
            assert p._allocated[placed].all()


TestPoolPairMachine = PoolPair.TestCase
TestPoolPairMachine.settings = settings(
    max_examples=8, stateful_step_count=30, deadline=None)


def test_machine_smoke():
    """One deterministic pass so the machine's rules stay exercised even
    under a minimal hypothesis profile."""
    run_state_machine_as_test(
        PoolPair, settings=settings(max_examples=3, stateful_step_count=25,
                                    deadline=None))


@pytest.mark.parametrize("tiers", [None, "ddr5:1,cxl:2"])
def test_flush_under_faults_equals_reference(tiers):
    """``flush_dirty`` with an injector in a transient and a degrade
    window: the same retry draws and billed time, the same checksum
    stamps (verified clean at the next page-in), and the same ``"flush"``
    intervals on the trace's modelled clock."""
    spec = "transient:0@0+50=0.6,degrade:0@1+50=0.5"
    pools = {}
    for name, pool_cls, hints, fmod, tracer in (
            ("t", PagedKVPool, _tree(HintTree, MemoryHint), tfaults,
             Tracer()),
            ("j", JPool, _tree(JHintTree, JMemoryHint), jfaults,
             JTracer())):
        kw = dict(device="cpu") if name == "t" else {}
        p = pool_cls(N_BLOCKS, HBM, SHAPE, hints=hints, tiers=tiers,
                     faults=fmod.FaultInjector(fmod.parse_fault_plan(spec),
                                               seed=5), **kw)
        p.attach_trace(tracer)
        pools[name] = (p, tracer)
    data = np.random.default_rng(3).standard_normal(
        (HBM,) + SHAPE).astype(np.float32)
    for rnd in range(3):
        ids = list(range(rnd * HBM, (rnd + 1) * HBM))
        reports = []
        for p, _ in pools.values():
            assert p.alloc(HBM) == ids
            reports.append(p.step(ids, hint_path="/t/mix"))
        assert reports[0] == reports[1]
        pools["t"][0].write(ids, torch.from_numpy(data + rnd))
        pools["j"][0].write(ids, jnp.asarray(data + rnd))
        out = [p.flush_dirty("/t/write") for p, _ in pools.values()]
        assert out[0] == out[1] and out[0]["page_outs"] == HBM
        assert pools["t"][0].flush_dirty() == {"page_outs": 0,
                                               "flush_us": 0.0}
        pools["j"][0].flush_dirty()
        _check_pair(pools["t"][0], pools["j"][0])
    (t, tt), (j, jt) = pools["t"], pools["j"]
    np.testing.assert_array_equal(t._csum_stamp, j._csum_stamp)
    assert t._fx.stats == j._fx.stats and t._fx.stats["retried"] > 0
    assert tt.timelines == jt.timelines
    assert tt.model_us == jt.model_us
    snap = t.snapshot_state()
    assert set(snap) == set(j.snapshot_state())
    np.testing.assert_array_equal(snap["csum_data"], j._csum_data)
    # the flushed copies verify at their next page-in
    for p in (t, j):
        p.step(list(range(HBM)), hint_path="/t/mix")
    assert t._fx.stats["quarantined"] == j._fx.stats["quarantined"] == 0
    _check_pair(t, j)
