"""Port's flat PagedKVPool against the JAX package's: the same op
sequences (alloc / write / step / free) replayed on both pools must leave
equal stats, per-scope billing, block tables, HBM and host-tier tensors,
and must call the same stream-kernel entry points with the same block
counts — including the pure page-in and pure page-out cases of
``tests/test_kv_pool.py:203-230`` and a fused transaction."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# tiny shapes: PyTorch's intra-op threads would only spin beside the
# other test workers
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro.serve import kv_pool as jkv_pool  # noqa: E402
from repro_torch.serve import kv_pool  # noqa: E402

SHAPE = (8, 32)


@pytest.fixture
def port_kernel_calls(monkeypatch):
    """The port's twin of the ``kernel_call_counter`` fixture."""
    calls: list[tuple[str, int]] = []
    for name in ("duplex_kv_stream", "dequant_kv_stream",
                 "quant_kv_stream"):
        real = getattr(kv_pool.kernel_ops, name)

        def counting(*a, _real=real, _name=name, **kw):
            calls.append((_name, a[0].shape[0]))
            return _real(*a, **kw)

        monkeypatch.setattr(kv_pool.kernel_ops, name, counting)
    return calls


class Pair:
    """One JAX pool and one port pool driven in lockstep."""

    def __init__(self, n=16, hbm=4):
        self.j = jkv_pool.PagedKVPool(n_blocks=n, hbm_blocks=hbm,
                                      block_shape=SHAPE)
        self.t = kv_pool.PagedKVPool(n_blocks=n, hbm_blocks=hbm,
                                     block_shape=SHAPE, device="cpu")

    def step(self, blocks):
        assert self.t.step(list(blocks)) == self.j.step(list(blocks))

    def write(self, blocks, seed):
        x = np.random.default_rng(seed).standard_normal(
            (len(blocks),) + SHAPE).astype(np.float32)
        self.j.write(list(blocks), jnp.asarray(x).astype(jnp.bfloat16))
        self.t.write(list(blocks), torch.from_numpy(x).to(torch.bfloat16))

    def fill(self, blocks, seed):
        self.step(blocks)
        self.write(blocks, seed)

    def free(self, blocks):
        self.j.free(list(blocks))
        self.t.free(list(blocks))

    def check(self):
        j, t = self.j, self.t
        assert t.stats == j.stats
        assert t.duplex_speedup() == j.duplex_speedup()
        assert t.tier_stats() == j.tier_stats()
        for name in ("slot_of", "block_at", "last_use", "_dirty",
                     "_has_host", "_allocated"):
            np.testing.assert_array_equal(getattr(t, name),
                                          getattr(j, name), err_msg=name)
        # tensors within the kernel tolerances of tests/test_kernels.py:
        # the reference's compiled quantizer multiplies by 1/127 where the
        # port divides, so a scale may differ by an ulp (rtol 1e-6) and an
        # int8 code by 1 LSB; a paged-in row then differs by at most that
        # LSB (one scale step) plus a bf16 rounding. Almost all match.
        jq, tq = np.asarray(j.host_q, np.int32), t.host_q.numpy()
        js, ts = np.asarray(j.host_scale), t.host_scale.numpy()
        np.testing.assert_allclose(ts, js, rtol=1e-6)
        assert np.abs(tq - jq).max() <= 1
        jh, th = np.asarray(j.hbm, np.float32), t.hbm.float().numpy()
        step = float(np.max(js))
        assert np.all(np.abs(th - jh) <= step + np.abs(jh) * 2.0 ** -7)
        assert np.mean(th == jh) >= 0.999 and np.mean(tq == jq) >= 0.999
        t.check_invariants()


def test_pure_page_in_uses_dequant_half(kernel_call_counter,
                                        port_kernel_calls):
    p = Pair()
    p.fill(range(4), seed=0)
    p.step(range(4, 8))                # spill 0..3 to host
    p.free(range(4, 8))                # all slots free again
    del kernel_call_counter[:], port_kernel_calls[:]
    p.step([0, 1, 2])                  # page-in only
    assert port_kernel_calls == kernel_call_counter == [
        ("dequant_kv_stream", 3)]
    p.check()


def test_pure_page_out_uses_quant_half(kernel_call_counter,
                                       port_kernel_calls):
    p = Pair()
    p.fill(range(4), seed=1)           # dirty residents, empty host
    del kernel_call_counter[:], port_kernel_calls[:]
    p.step([4, 5])                     # evicts 2 dirty: page-out only
    assert port_kernel_calls == kernel_call_counter == [
        ("quant_kv_stream", 2)]
    assert p.t.stats["duplex_us"] > 0
    p.check()


def test_mixed_traffic_is_one_fused_pass(kernel_call_counter,
                                         port_kernel_calls):
    p = Pair()
    p.fill(range(4), seed=2)
    p.step(range(4, 8))                # spill 0..3
    p.fill(range(4, 8), seed=3)        # dirty residents again
    del kernel_call_counter[:], port_kernel_calls[:]
    p.step([0, 1, 2])                  # 3 ins co-issued with 3 outs
    assert port_kernel_calls == kernel_call_counter == [
        ("duplex_kv_stream", 4)]       # padded to the staging depth
    p.check()


@pytest.mark.parametrize("seed", [0, 1])
def test_random_churn_replays_identically(seed, kernel_call_counter,
                                          port_kernel_calls):
    """Random alloc/write/step/free sequences with rewrites, clean
    evictions and recycled ids."""
    rng = np.random.default_rng(seed)
    p = Pair(n=24, hbm=6)
    owned: list[list[int]] = []
    for it in range(40):
        op = rng.random()
        if op < 0.35 or not owned:
            ids = p.t.alloc(int(rng.integers(1, 3)))
            assert p.j.alloc(len(ids)) == ids
            owned.append(ids)
            p.fill(ids, seed=1000 * seed + it)
        elif op < 0.8:
            pick = sorted({b for ids in owned for b in ids})
            demand = rng.permutation(pick)[:int(rng.integers(1, 6))]
            p.step(demand.tolist())
            if rng.random() < 0.5:
                p.write(demand[:1].tolist(), seed=5000 * seed + it)
        else:
            p.free(owned.pop(int(rng.integers(0, len(owned)))))
        p.check()
    assert port_kernel_calls == kernel_call_counter
    assert p.t.stats["page_ins"] > 0 and p.t.stats["page_outs"] > 0
    assert p.t.stats["by_path"] == p.j.stats["by_path"]


def test_sentinel_rows_are_dropped():
    """Out-of-range ids are padding: their rows never land anywhere (the
    reference's ``mode="drop"`` scatter)."""
    p = Pair(n=8, hbm=4)
    p.step([0, 1])
    x = np.random.default_rng(9).standard_normal((4,) + SHAPE).astype(
        np.float32)
    ids = [0, 8, 1, 99]
    p.j.write(ids, jnp.asarray(x).astype(jnp.bfloat16))
    p.t.write(ids, torch.from_numpy(x).to(torch.bfloat16))
    p.check()


def test_device_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("this checks the no-GPU behaviour")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        kv_pool.PagedKVPool(n_blocks=4, hbm_blocks=2, block_shape=SHAPE)
