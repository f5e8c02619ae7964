"""The port's training CLI (``python -m repro_torch.launch.train``)
against the reference CLI (``repro.launch.train``), both ``main()``s run
in-process on the SMOKE configs of smollm-135m and rwkv6-7b, with and
without ``--host-optimizer``, and across ``--ckpt-dir`` / ``--resume``.
The port's trainer starts from the reference's own weights (its
``init_state`` patched to convert them: each package draws its own
random weights otherwise). Both print the same lines: the arch line
(parameters; the port counts one device on the CPU, the reference
``jax.device_count()``, which forced host devices elsewhere in the
process can raise), the history's steps, the retries,
and the host optimizer's link report (its modelled keys exactly; the
port adds the measured ``measured_us``). Losses: step 0 within 1e-4
relative (the bf16 forward, ``tests/test_torch_models.py``'s
tolerance, read 8e-6 and 2e-5), later steps within 1e-3 relative (each
step rounds the updated weights to bf16 in another framework's order;
read up to 2e-4). Left out: ``sec`` and the straggler count (host
clock). Then the port's CLI as a user runs it, in a subprocess:
``--device cpu`` trains, the default ``cuda`` raises without a GPU."""

import contextlib
import io
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.launch import train as jtrain  # noqa: E402
from repro.models import registry as R  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models import rwkv6 as TW  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.optim import adamw_init  # noqa: E402
from repro_torch.runtime import train as TRT  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CONVERT = {"smollm-135m": TT, "rwkv6-7b": TW}
BASE = ["train", "--steps", "6", "--seq-len", "32", "--global-batch", "4"]


def _run(main, argv, monkeypatch) -> list[str]:
    monkeypatch.setattr(sys, "argv", argv)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert main() == 0
    return out.getvalue().strip().splitlines()


def _reference_weights(arch, monkeypatch):
    """Make the port's Trainer start from the reference's init (seed 0)."""
    jp = R.build(arch, smoke=True).init(jax.random.PRNGKey(0))
    npt = jax.tree.map(lambda a: np.asarray(a, np.float32), jp)

    def init_state(self, generator=None):
        params = CONVERT[arch].params_from_jax(npt, self.api.cfg)
        opt = (self.host_opt.init(params) if self.host_opt is not None
               else adamw_init(params))
        return params, opt

    monkeypatch.setattr(TRT.Trainer, "init_state", init_state)


def _parse(lines):
    hist = [json.loads(x) for x in lines if x.startswith("{")]
    report = [json.loads(x.split(": ", 1)[1]) for x in lines
              if x.startswith("host-optimizer link report:")]
    final = re.fullmatch(r"final loss (\S+) \((\d+) retries, \d+ straggler "
                         r"steps\)", lines[-1])
    assert final, lines[-1]
    others = [x for x in lines[:-1] if not x.startswith(("{", "host-"))]
    return hist, report, float(final.group(1)), int(final.group(2)), others


def _no_devices(line: str) -> str:
    """The line without its device count: the reference prints
    ``jax.device_count()``, which another test in the same process may
    have raised with forced host devices; the port's is checked apart."""
    return re.sub(r"devices=\d+$", "devices=", line)


def _same(got, want):
    gh, gr, gf, gret, go = _parse(got)
    wh, wr, wf, wret, wo = _parse(want)
    # the arch line and "resumed from step N"
    assert [_no_devices(x) for x in go] == [_no_devices(x) for x in wo]
    assert [h["step"] for h in gh] == [h["step"] for h in wh]
    for i, (a, b) in enumerate(zip(gh, wh)):
        assert set(a) == set(b) == {"step", "loss", "sec"}
        tol = 1e-4 if a["step"] == 0 else 1e-3
        assert abs(a["loss"] - b["loss"]) <= tol * abs(b["loss"]), (i, a, b)
    assert abs(gf - wf) <= 1e-3 * abs(wf) + 1e-4
    assert gret == wret
    assert len(gr) == len(wr)
    for a, b in zip(gr, wr):
        assert {k: a[k] for k in b} == b
        assert a["measured_us"] > 0


@pytest.mark.parametrize("host", [False, True])
@pytest.mark.parametrize("arch", ["smollm-135m", "rwkv6-7b"])
def test_train_cli_equals_reference(arch, host, monkeypatch):
    argv = BASE + ["--arch", arch] + (["--host-optimizer"] if host else [])
    want = _run(jtrain.main, argv, monkeypatch)
    _reference_weights(arch, monkeypatch)
    got = _run(ttrain.main, argv + ["--device", "cpu"], monkeypatch)
    assert got[0].startswith(f"arch={arch} params=")
    assert got[0].endswith("devices=1")
    _same(got, want)


def test_train_cli_checkpoint_and_resume_equal_reference(monkeypatch,
                                                         tmp_path):
    """Six steps with a checkpoint every 3, then ``--resume`` to 8: both
    resume from step 6 and print the same lines."""
    outs = {}
    for pkg, main in (("jax", jtrain.main), ("torch", ttrain.main)):
        d = str(tmp_path / pkg)
        extra = ["--device", "cpu"] if pkg == "torch" else []
        if pkg == "torch":
            _reference_weights("smollm-135m", monkeypatch)
        first = _run(main, BASE + ["--ckpt-dir", d, "--ckpt-every", "3",
                                   *extra], monkeypatch)
        assert sorted(os.listdir(d)) == ["step_000000003",
                                         "step_000000006"]
        again = _run(main, ["train", "--steps", "8", "--seq-len", "32",
                            "--global-batch", "4", "--ckpt-dir", d,
                            "--resume", *extra], monkeypatch)
        assert "resumed from step 6" in again
        outs[pkg] = (first, again)
    for got, want in zip(outs["torch"], outs["jax"]):
        _same(got, want)


def test_train_cli_host_optimizer_resume_raises_in_both(monkeypatch,
                                                        tmp_path):
    """``--host-optimizer --resume`` in a fresh process: the reference's
    restore reads the host moments before any step made them
    (AttributeError); the port keeps that behaviour (ROADMAP Queue 3)."""
    for pkg, main in (("jax", jtrain.main), ("torch", ttrain.main)):
        d = str(tmp_path / pkg)
        extra = ["--device", "cpu"] if pkg == "torch" else []
        _run(main, BASE + ["--steps", "2", "--ckpt-dir", d, *extra],
             monkeypatch)
        monkeypatch.setattr(sys, "argv", BASE + [
            "--ckpt-dir", d, "--resume", "--host-optimizer", *extra])
        with contextlib.redirect_stdout(io.StringIO()), \
                pytest.raises(AttributeError, match="_m"):
            main()


def _cli(*args):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", *args], env=env,
        capture_output=True, text=True, timeout=300)


def test_train_cli_runs_as_a_user_runs_it():
    out = _cli("--device", "cpu", "--steps", "2", "--seq-len", "16",
               "--global-batch", "2")
    assert out.returncode == 0, out.stderr
    lines = out.stdout.strip().splitlines()
    assert lines[0].startswith("arch=smollm-135m ")
    assert lines[-1].startswith("final loss ")
    if not torch.cuda.is_available():
        out = _cli("--steps", "1")
        assert out.returncode != 0
        assert "no CUDA device is available" in out.stderr
