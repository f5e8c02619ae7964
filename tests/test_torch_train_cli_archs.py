"""The port's training CLI against the reference CLI on the six archs
``tests/test_torch_train_cli.py`` does not run: whisper-base,
paligemma-3b, zamba2-7b and qwen2.5-14b on their SMOKE configs as they
are (bf16), with that file's tolerances (step 0 within 1e-4 relative,
later steps and the final loss within 1e-3), and the MoE archs
mixtral-8x7b and kimi-k2-1t-a32b on their SMOKE configs in f32 (both
packages' ``get_config`` patched to an f32 dtype): in bf16 the jitted
reference loss and the port's eager one round the router logits apart,
a near tie then flips a token's experts and moves the loss by the gap
between two experts. In f32 the routings agree
(``tests/test_torch_train_steps.py``) and the losses are held to 1e-4
relative at every step (the update still runs in another framework's
order). Both ``main()``s run in-process, the port's
trainer from the reference's own weights."""

import contextlib
import dataclasses
import io
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro import configs as jconfigs  # noqa: E402
from repro.launch import train as jtrain  # noqa: E402
from repro.models import registry as R  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models import encdec as TE  # noqa: E402
from repro_torch.models import hybrid as TH  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.optim import adamw_init  # noqa: E402
from repro_torch.runtime import train as TRT  # noqa: E402

sys.path.insert(0, str(__import__("pathlib").Path(__file__).parent))
from test_torch_train_cli import _parse, _run, _same  # noqa: E402

CONVERT = {"whisper-base": TE, "zamba2-7b": TH}
BASE = ["train", "--steps", "6", "--seq-len", "32", "--global-batch", "4"]
F32_TOL = 1e-4


def _reference_weights(arch, monkeypatch):
    """Make the port's Trainer start from the reference's init (seed 0)."""
    jp = R.build(arch, smoke=True).init(jax.random.PRNGKey(0))
    npt = jax.tree.map(lambda a: np.asarray(a, np.float32), jp)
    conv = CONVERT.get(arch, TT)

    def init_state(self, generator=None):
        params = conv.params_from_jax(npt, self.api.cfg)
        opt = (self.host_opt.init(params) if self.host_opt is not None
               else adamw_init(params))
        return params, opt

    monkeypatch.setattr(TRT.Trainer, "init_state", init_state)


def _f32_configs(monkeypatch):
    for mod, dt in ((jconfigs, jnp.float32), (tconfigs, torch.float32)):
        real = mod.get_config
        monkeypatch.setattr(
            mod, "get_config",
            lambda a, smoke=False, _r=real, _d=dt: dataclasses.replace(
                _r(a, smoke=smoke), dtype=_d))


@pytest.mark.parametrize("arch", ["whisper-base", "paligemma-3b",
                                  "zamba2-7b", "qwen2.5-14b"])
def test_train_cli_equals_reference_on_the_other_archs(arch, monkeypatch):
    argv = BASE + ["--arch", arch]
    want = _run(jtrain.main, argv, monkeypatch)
    _reference_weights(arch, monkeypatch)
    got = _run(ttrain.main, argv + ["--device", "cpu"], monkeypatch)
    assert got[0].startswith(f"arch={arch} params=")
    _same(got, want)


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "kimi-k2-1t-a32b"])
def test_train_cli_equals_reference_on_the_moe_archs_in_f32(arch,
                                                            monkeypatch):
    _f32_configs(monkeypatch)
    argv = BASE + ["--arch", arch]
    want = _run(jtrain.main, argv, monkeypatch)
    _reference_weights(arch, monkeypatch)
    got = _run(ttrain.main, argv + ["--device", "cpu"], monkeypatch)
    gh, _gr, gf, gret, _go = _parse(got)
    wh, _wr, wf, wret, _wo = _parse(want)
    assert [h["step"] for h in gh] == [h["step"] for h in wh]
    for a, b in zip(gh, wh):
        assert abs(a["loss"] - b["loss"]) <= F32_TOL * abs(b["loss"]), (
            a, b)
    assert abs(gf - wf) <= F32_TOL * abs(wf)
    assert gret == wret
