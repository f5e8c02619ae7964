"""Port's ``ShardedKVPool`` against the reference's, and its state round
trip (``tests/test_kv_pool_state.py``'s ``ShardedPoolMachine``): a
hypothesis state machine drives a port facade and a JAX facade of two
shards in lockstep through random ``alloc`` (by shard) / ``free`` /
``invalidate`` / ``write`` / ``step`` (cross-shard demand groups) /
``migrate_tiers`` sequences, flat and tiered, and after every rule both
facades' merged ``stats`` and ``tier_stats`` are equal, every shard's
block tables and host placement are equal, and the pool tensors agree
within the kernel tolerances (a scale to rtol 1e-6, an int8 code to
1 LSB, as ``tests/test_torch_kv_pool.py``); the port facade also keeps
its ownership invariants, and its ``snapshot_roundtrip`` rule is the
reference's (flush, capture, mutate, load, bit-for-bit back). One seeded
operation sequence, with a fault plan on the tiered pool, is run through
both facades outside hypothesis too."""

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
from repro.serve.shard import ShardedKVPool as JShardedPool  # noqa: E402
from repro_torch.core import faults as tfaults  # noqa: E402
from repro_torch.core.hints import HintTree, MemoryHint  # noqa: E402
from repro_torch.serve.shard import ShardedKVPool  # noqa: E402

N_SHARDS = 2
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


def _pools(tiers, plan=None):
    """(port facade, reference facade), each on its own injector of
    ``plan`` when given."""
    faults = [None, None]
    if plan is not None:
        faults = [mod.FaultInjector(mod.parse_fault_plan(plan), seed=5)
                  for mod in (tfaults, jfaults)]
    return (ShardedKVPool(N_SHARDS, N_BLOCKS, HBM, SHAPE,
                          hints=_tree(HintTree, MemoryHint), tiers=tiers,
                          faults=faults[0], device="cpu"),
            JShardedPool(N_SHARDS, N_BLOCKS, HBM, SHAPE,
                         hints=_tree(JHintTree, JMemoryHint), tiers=tiers,
                         faults=faults[1]))


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
    """The port facade against the reference facade: merged host state
    exact, every shard's tables exact, tensors within the kernel
    tolerances."""
    assert t.stats == j.stats
    assert t.tier_stats() == j.tier_stats()
    np.testing.assert_array_equal(t.slot_of, j.slot_of)
    np.testing.assert_array_equal(t._allocated, j._allocated)
    np.testing.assert_array_equal(t.resident_blocks(), j.resident_blocks())
    for ts, js in zip(t.shards, j.shards):
        for name in ("block_at", "last_use", "_dirty", "_has_host"):
            np.testing.assert_array_equal(getattr(ts, name),
                                          getattr(js, name), err_msg=name)
        for name in ("slot_of", "block_of", "pref"):
            np.testing.assert_array_equal(getattr(ts.host, name),
                                          getattr(js.host, name),
                                          err_msg=name)
        jq, tq = np.asarray(js.host_q, np.int32), ts.host_q.numpy()
        scale = np.asarray(js.host_scale)
        np.testing.assert_allclose(ts.host_scale.numpy(), scale, rtol=1e-6)
        assert np.abs(tq - jq).max() <= 1
        jh, th = np.asarray(js.hbm, np.float32), ts.hbm.float().numpy()
        step = float(np.max(scale))
        assert np.all(np.abs(th - jh) <= step + np.abs(jh) * 2.0 ** -7)


def _write(pools, ids, seed):
    data = np.random.default_rng(seed).standard_normal(
        (len(ids),) + SHAPE).astype(np.float32)
    pools[0].write(np.asarray(ids, np.int32), torch.from_numpy(data))
    pools[1].write(np.asarray(ids, np.int32), jnp.asarray(data))


class ShardedPoolPair(RuleBasedStateMachine):
    """The reference's ``ShardedPoolMachine`` rules, each applied to a
    port facade and a reference facade."""

    @initialize(tiers=st.sampled_from([None, "ddr5:1,cxl:1",
                                       "ddr5:2,cxl:2"]))
    def setup(self, tiers):
        self.pool, self.ref = _pools(tiers)

    def _pick(self, seed: int, pop: np.ndarray, k: int) -> list[int]:
        if pop.size == 0 or k <= 0:
            return []
        rng = np.random.default_rng(seed)
        return rng.choice(pop, size=min(k, pop.size),
                          replace=False).tolist()

    def _allocated_global(self) -> np.ndarray:
        return np.flatnonzero(self.pool._allocated)

    @rule(shard=st.integers(0, N_SHARDS - 1), k=st.integers(1, 3))
    def alloc(self, shard, k):
        sh = self.pool.shards[shard]
        if int((~sh._allocated).sum()) >= k:
            ids = self.pool.alloc(k, shard=shard)
            assert ids == self.ref.alloc(k, shard=shard)
            # allocation lands in the owning shard's global band only
            assert all(self.pool.shard_of(b) == shard for b in ids)

    @rule(seed=st.integers(0, 2**31 - 1), k=st.integers(1, 4))
    def free(self, seed, k):
        ids = self._pick(seed, self._allocated_global(), k)
        self.pool.free(ids)
        self.ref.free(ids)

    @rule(seed=st.integers(0, 2**31 - 1), k=st.integers(1, 3))
    def invalidate(self, seed, k):
        ids = self._pick(seed, self._allocated_global(), k)
        self.pool.invalidate(ids)
        self.ref.invalidate(ids)

    @rule(seed=st.integers(0, 2**31 - 1), k=st.integers(1, HBM),
          scope=st.sampled_from(SCOPES))
    def step(self, seed, k, scope):
        # k <= HBM keeps every shard's routed share within its working
        # set, however the global pick lands across the bands
        ids = self._pick(seed, self._allocated_global(), k)
        if ids:
            # a cross-shard demand group: the facade must split it
            assert self.pool.step(ids, hint_path=scope) == \
                self.ref.step(ids, hint_path=scope)

    @rule(seed=st.integers(0, 2**31 - 1), k=st.integers(1, HBM))
    def write_resident(self, seed, k):
        ids = self._pick(seed, self.pool.resident_blocks(), k)
        if ids:
            _write((self.pool, self.ref), ids, seed)

    @rule(max_moves=st.integers(0, 4))
    def migrate(self, max_moves):
        assert self.pool.migrate_tiers(max_moves=max_moves) == \
            self.ref.migrate_tiers(max_moves=max_moves)

    @rule(seed=st.integers(0, 2**31 - 1),
          shard=st.integers(0, N_SHARDS - 1))
    def snapshot_roundtrip(self, seed, shard):
        """The facade's snapshot is per-shard state fanned into one tree;
        restoring it must rebuild every shard bit for bit, its tensors
        written in place."""
        assert self.pool.flush_dirty() == self.ref.flush_dirty()
        _check_pair(self.pool, self.ref)
        snap = self.pool.snapshot_state()
        tensors = [(sh.hbm, sh.host_q, sh.host_scale)
                   for sh in self.pool.shards]
        ids = self._pick(seed, self._allocated_global(), 2)
        if ids:
            self.pool.step(ids, hint_path="/t/mix")
            self.pool.free(ids[:1])
        sh = self.pool.shards[shard]
        if int((~sh._allocated).sum()) > 0:
            self.pool.alloc(1, shard=shard)
        self.pool.load_state(snap)
        _assert_state_equal(snap, self.pool.snapshot_state())
        assert all(a is b for t, sh in zip(tensors, self.pool.shards)
                   for a, b in zip(t, (sh.hbm, sh.host_q, sh.host_scale)))

    @invariant()
    def shards_consistent(self):
        if not hasattr(self, "pool"):
            return
        # per-shard tables + cross-shard global-id disjointness
        self.pool.check_invariants()
        _check_pair(self.pool, self.ref)
        p = self.pool
        for sh in p.shards:
            assert len(sh.resident_blocks()) <= p.hbm_capacity
            assert not (sh._dirty & ~sh._allocated).any()
            assert not (sh._has_host & ~sh._allocated).any()
        # the facade's global views are exactly the shard bands, in order
        assert p._allocated.size == N_SHARDS * N_BLOCKS
        assert len(p.resident_blocks()) <= N_SHARDS * p.hbm_capacity


TestShardedPoolPairMachine = ShardedPoolPair.TestCase
TestShardedPoolPairMachine.settings = settings(
    max_examples=8, stateful_step_count=30, deadline=None)


def test_machine_smoke():
    """One deterministic pass so the machine's rules stay exercised even
    under a minimal hypothesis profile."""
    run_state_machine_as_test(
        ShardedPoolPair, settings=settings(max_examples=3,
                                           stateful_step_count=25,
                                           deadline=None))


@pytest.mark.parametrize("tiers,plan", [
    (None, None),
    ("ddr5:1,cxl:2", "transient:0@2+30=0.5,poison:17@6,offline:2@12"),
])
def test_seeded_sequence_equals_reference(tiers, plan):
    """A seeded sequence of rounds (allocate on both shards, a
    cross-shard step, write the resident blocks, read some back, free,
    migrate, flush) through both facades: equal reports, stats, tier
    stats, tables, ``read`` results and tensors; with a fault plan, the
    same retry draws, evacuations and fault counters (the poison aimed at
    shard 1's band re-arms through its view, in global ids, since its
    block never pages back in) and the offline channel lost on both
    shards."""
    pool, ref = _pools(tiers, plan)
    rng = np.random.default_rng(13)
    for rnd in range(16):
        for shard in range(N_SHARDS):
            if int((~pool.shards[shard]._allocated).sum()) >= 2:
                assert pool.alloc(2, shard=shard) == \
                    ref.alloc(2, shard=shard)
        live = np.flatnonzero(pool._allocated)
        ids = rng.choice(live, size=min(HBM, live.size),
                         replace=False).tolist()
        scope = SCOPES[rnd % len(SCOPES)]
        assert pool.step(ids, hint_path=scope) == \
            ref.step(ids, hint_path=scope)
        res = pool.resident_blocks().tolist()
        _write((pool, ref), res, rnd)
        back = res[::-1][:3]
        got = pool.read(back).float().numpy()
        want = np.asarray(ref.read(back), np.float32)
        np.testing.assert_array_equal(got, want)
        if rnd % 3 == 2:
            pool.free(ids[:2])
            ref.free(ids[:2])
        assert pool.migrate_tiers() == ref.migrate_tiers()
        if rnd % 5 == 4:
            assert pool.flush_dirty() == ref.flush_dirty()
        pool.check_invariants()
        _check_pair(pool, ref)
    if plan is not None:
        assert pool._fx.stats == ref._fx.stats
        assert pool._fx.stats["offline_channels"] == [2]
        for sh in pool.shards:
            assert bool(sh.host.offline[2])
