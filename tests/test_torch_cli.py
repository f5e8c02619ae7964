"""The port's serve CLI against the reference CLI: under each of the six
admission policies, both ``main()``s run in-process on the SMOKE config
(``--device cpu`` for the port) and print the same JSON report, field for
field. Left out of the comparison: the wall clock (``wall_s``,
``tok_s``) and the port's ``device`` field, which the reference's report
does not have. The tokens themselves are not in the report (each CLI
draws its own random weights)."""

import contextlib
import io
import json
import sys

import pytest

torch = pytest.importorskip("torch")
# tiny shapes: PyTorch's intra-op threads would only spin beside the
# other test workers
torch.set_num_threads(1)

from repro.core import policies as jpolicies  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402

UNCOMPARED = {"wall_s", "tok_s", "device"}


def _report(main, argv, monkeypatch) -> dict:
    monkeypatch.setattr(sys, "argv", argv)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert main() == 0
    return json.loads(out.getvalue().strip().splitlines()[-1])


@pytest.mark.parametrize("policy", list(jpolicies.REGISTRY))
def test_cli_report_equals_reference(policy, monkeypatch):
    argv = ["serve", "--requests", "4", "--gen", "4", "--no-warmup",
            "--policy", policy]
    want = _report(jserve.main, argv, monkeypatch)
    got = _report(tserve.main, argv + ["--device", "cpu"], monkeypatch)
    assert got["device"] == "cpu"
    assert set(got) - UNCOMPARED == set(want) - UNCOMPARED
    for key in set(want) - UNCOMPARED:
        assert got[key] == want[key], key
    assert got["policy"] == policy and got["generated_tokens"] == 16
