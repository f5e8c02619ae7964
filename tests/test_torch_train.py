"""The port's ``Trainer`` against the JAX package's: its behaviours as
the reference's own tests hold them (``tests/test_runtime.py``: loss
falls, a transient fault is retried, a straggler is detected,
checkpoint/resume is bit-identical, an unrecoverable fault rolls back,
elastic resume; ``tests/test_system.py``: host-optimizer parity, train
then serve through the port's ``ServeEngine``), three steps of both
packages' trainers from the same f32 weights (losses within 1e-5
relative), and the reference's host-optimizer restore, which raises
``AttributeError`` before any step in both packages and keeps the
current moments on a rollback (ROADMAP Queue 3)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.models import registry as R  # noqa: E402
from repro.optim import AdamWConfig as JAdamW  # noqa: E402
from repro.optim import adamw_init as jadamw_init  # noqa: E402
from repro.runtime.train import TrainConfig as JTrainConfig  # noqa: E402
from repro.runtime.train import Trainer as JTrainer  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import registry as TR  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.optim import AdamWConfig, adamw_init  # noqa: E402
from repro_torch.runtime import FaultInjector, TrainConfig, Trainer  # noqa: E402
from repro_torch.serve import EngineConfig, ServeEngine  # noqa: E402


def _f32_smollm():
    """(jax api, jax params, port api, port params) of smollm-135m SMOKE
    in f32, the port's converted from the reference's own init."""
    arch = "smollm-135m"
    api = R.build(arch, smoke=True)
    params = api.init(jax.random.PRNGKey(0))
    japi = R._lm_api(arch, dataclasses.replace(api.cfg, dtype=jnp.float32))
    jp = jax.tree.map(lambda a: a.astype(jnp.float32), params)
    tcfg = dataclasses.replace(TR.build(arch, smoke=True, device="cpu").cfg,
                               dtype=torch.float32)
    npt = jax.tree.map(lambda a: np.asarray(a, np.float32), params)
    return (japi, jp, TR._lm_api(arch, tcfg, "cpu"),
            TT.params_from_jax(npt, tcfg))


def _api(arch="smollm-135m"):
    return TR.build(arch, smoke=True, device="cpu")


def _cfg(**kw):
    base = dict(seq_len=32, global_batch=4, steps=6,
                optim=AdamWConfig(warmup_steps=2, total_steps=6))
    base.update(kw)
    return TrainConfig(**base)


class TestTraining:
    """The reference's tests/test_runtime.py cases, on the port."""

    def test_loss_decreases(self):
        tr = Trainer(_api(), _cfg(steps=12, optim=AdamWConfig(
            peak_lr=5e-3, warmup_steps=2, total_steps=12)))
        _, _, hist = tr.run()
        first = np.mean([h["loss"] for h in hist[:3]])
        last = np.mean([h["loss"] for h in hist[-3:]])
        assert last < first

    def test_transient_fault_retried(self):
        tr = Trainer(_api(), _cfg(),
                     fault_injector=FaultInjector(fail_steps=(2,)))
        _, _, hist = tr.run()
        assert tr.retried_steps == [2]
        assert len(hist) == 6

    def test_straggler_detected(self):
        tr = Trainer(_api(), _cfg(steps=10, straggler_factor=2.0),
                     fault_injector=FaultInjector(slow_steps=(7,),
                                                  slow_s=1.0))
        tr.run()
        assert 7 in tr.straggler_steps

    def test_checkpoint_resume_identical(self, tmp_path):
        """train(10) == train(5) + resume(5..10), bit for bit."""
        opt = AdamWConfig(peak_lr=1e-3, warmup_steps=2, total_steps=10,
                          grad_dtype=torch.float32)
        p_straight, _, _ = Trainer(_api(), _cfg(steps=10, optim=opt)).run()
        d = str(tmp_path / "ck")
        Trainer(_api(), _cfg(steps=5, optim=opt, ckpt_dir=d,
                             ckpt_every=100)).run()
        part2 = Trainer(_api(), _cfg(steps=10, optim=opt, ckpt_dir=d,
                                     ckpt_every=100))
        (params, opt_state), start = part2.restore()
        assert start == 5
        assert opt_state["step"].dtype == torch.int32
        assert int(opt_state["step"]) == 5
        p_resumed, _, _ = part2.run(params, opt_state, start)
        for a, b in zip(TL.tree_leaves(p_straight),
                        TL.tree_leaves(p_resumed)):
            assert a.dtype == b.dtype
            assert torch.equal(a, b)

    def test_unrecoverable_fault_rolls_back(self, tmp_path):
        d = str(tmp_path / "ck")
        tr = Trainer(_api(), _cfg(steps=8, ckpt_dir=d, ckpt_every=2,
                                  max_retries=1),
                     fault_injector=FaultInjector(
                         fail_steps=(5,), max_failures_per_step=5))
        _, _, hist = tr.run()
        assert len(tr.retried_steps) >= 2
        assert hist[-1]["step"] == 7

    def test_elastic_resume_preserves_stream(self):
        from repro_torch.data import DataConfig, make_batch
        cfg = DataConfig(vocab=100, seq_len=16, global_batch=4)
        full = make_batch(cfg, step=3, dp_rank=0, dp_size=1)
        halves = [make_batch(cfg, step=3, dp_rank=r, dp_size=2)
                  for r in range(2)]
        np.testing.assert_array_equal(
            full["tokens"], np.concatenate([h["tokens"] for h in halves]))

    def test_ranks_train_on_their_slice(self):
        tr = Trainer(_api(), _cfg(steps=2, global_batch=4, dp_rank=1,
                                  dp_size=2))
        seen = []
        real = tr._one_step

        def spy(params, opt_state, batch):
            seen.append(batch["tokens"].shape)
            return real(params, opt_state, batch)

        tr._one_step = spy
        tr.run()
        assert seen == [(2, 32), (2, 32)]


def test_trainer_losses_equal_reference_float32():
    """Three Trainer steps of both packages from the same f32 weights:
    the same batches (bit-equal pipeline), losses within 1e-5
    relative."""
    japi, jp, tapi, tp = _f32_smollm()
    kw = dict(seq_len=16, global_batch=2, steps=3)
    jt = JTrainer(japi, JTrainConfig(optim=JAdamW(
        warmup_steps=1, total_steps=3, grad_dtype=jnp.float32), **kw))
    tt = Trainer(tapi, TrainConfig(optim=AdamWConfig(
        warmup_steps=1, total_steps=3, grad_dtype=torch.float32), **kw))
    _, _, jh = jt.run(jp, jadamw_init(jp))
    _, _, th = tt.run(tp, adamw_init(tp))
    assert [h["step"] for h in th] == [h["step"] for h in jh] == [0, 1, 2]
    for a, b in zip(th, jh):
        assert abs(a["loss"] - b["loss"]) <= 1e-5 * abs(b["loss"])


def test_host_offload_trains_like_device():
    """The reference's capacity story (tests/test_system.py): the host
    pool optimizer trains as the device one (atol 1e-5)."""
    opt = AdamWConfig(peak_lr=1e-3, warmup_steps=1, total_steps=4,
                      grad_dtype=torch.float32)
    a = Trainer(_api(), TrainConfig(seq_len=32, global_batch=4, steps=4,
                                    optim=opt))
    pa, _, _ = a.run()
    b = Trainer(_api(), TrainConfig(seq_len=32, global_batch=4, steps=4,
                                    optimizer_placement="host", optim=opt))
    pb, _, _ = b.run()
    for la, lb in zip(TL.tree_leaves(pa), TL.tree_leaves(pb)):
        np.testing.assert_allclose(la.float().numpy(), lb.float().numpy(),
                                   atol=1e-5)
    rep = b.host_opt.last_transfer_report
    assert rep["duplex_speedup"] > 1.3
    assert rep["measured_us"] > 0


def test_train_then_serve():
    """Train a reduced model, then serve it through the port's
    ServeEngine (tests/test_system.py's story)."""
    api = _api()
    tr = Trainer(api, TrainConfig(seq_len=32, global_batch=4, steps=6,
                                  optim=AdamWConfig(warmup_steps=2,
                                                    total_steps=6)))
    params, _, hist = tr.run()
    assert all(np.isfinite(h["loss"]) for h in hist)
    eng = ServeEngine(api, params, EngineConfig(max_batch=2, cache_len=64,
                                                megastep=4, device="cpu"))
    rids = [eng.submit(np.ones(4, np.int32), 8).rid for _ in range(2)]
    outs = eng.run(max_steps=200)
    assert all(tuple(outs[r].shape) == (8,) for r in rids)


def test_host_optimizer_restore_raises_before_any_step_in_both(tmp_path):
    """The reference's ``restore`` evaluates ``host_opt._m`` eagerly; in a
    fresh process (no step run yet) it does not exist: both packages
    raise AttributeError (ROADMAP Queue 3)."""
    jd, td = str(tmp_path / "j"), str(tmp_path / "t")
    JTrainer(R.build("smollm-135m", smoke=True), JTrainConfig(
        seq_len=16, global_batch=2, steps=1, ckpt_dir=jd)).run()
    Trainer(_api(), TrainConfig(seq_len=16, global_batch=2, steps=1,
                                ckpt_dir=td)).run()
    jt = JTrainer(R.build("smollm-135m", smoke=True), JTrainConfig(
        seq_len=16, global_batch=2, steps=2, ckpt_dir=jd,
        optimizer_placement="host"))
    tt = Trainer(_api(), TrainConfig(seq_len=16, global_batch=2, steps=2,
                                     ckpt_dir=td,
                                     optimizer_placement="host"))
    with pytest.raises(AttributeError, match="_m"):
        jt.restore()
    with pytest.raises(AttributeError, match="_m"):
        tt.restore()


def test_host_optimizer_rollback_keeps_current_moments(tmp_path):
    """The reference stores no host moments, so a rollback restores the
    params and the step but keeps the moments as they are."""
    d = str(tmp_path / "ck")
    tr = Trainer(_api(), _cfg(steps=4, ckpt_dir=d, ckpt_every=2,
                              optimizer_placement="host"))
    tr.run()
    m_before = [m.clone() for m in TL.tree_leaves(tr.host_opt._m)]
    (params, opt), step = tr.restore()
    assert step == 4 and set(opt) == {"step"}
    for a, b in zip(m_before, TL.tree_leaves(tr.host_opt._m)):
        assert torch.equal(a, b)
