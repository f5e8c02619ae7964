"""The port's serve CLI against the reference CLI: under each of the six
admission policies, and under the tiered host pool and fault plans
(``--tiers``, ``--no-tier-migrate``, ``--faults``, with tenants too),
both ``main()``s run in-process on the SMOKE config (``--device cpu``
for the port) and print the same JSON report, field for field; the
parse-time errors of ``--tiers`` and ``--faults`` read the same. Left
out of the comparison: the wall clock (``wall_s``, ``tok_s``) and the
port's ``device`` field, which the reference's report
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


TIER_FAULT_FLAGS = {
    "tiers": ["--tiers", "ddr5:2,cxl:2"],
    "tiers-frozen": ["--tiers", "ddr5:2,cxl:2", "--no-tier-migrate"],
    "faults-flat": ["--faults",
                    "degrade:0@3+10=0.5,transient:0@5+20=0.3,poison:2@8",
                    "--fault-seed", "4"],
    "faults-offline": ["--tiers", "ddr5:1,cxl:2", "--faults",
                       "offline:2@12,poison:4@8,transient:1@2+30=0.4"],
    "tenants-tiers": ["--tenants", "redis,vectordb", "--tiers",
                      "ddr5:2,cxl:2"],
}


@pytest.mark.parametrize("flags", list(TIER_FAULT_FLAGS))
def test_cli_tiers_and_faults_equal_reference(flags, monkeypatch):
    """Every field equal; ``failed_requests`` is keyed by rid, which both
    packages draw from process-wide counters, so its records are compared
    in rid order."""
    argv = ["serve", "--gen", "12", "--no-warmup", *TIER_FAULT_FLAGS[flags]]
    want = _report(jserve.main, argv, monkeypatch)
    got = _report(tserve.main, argv + ["--device", "cpu"], monkeypatch)
    assert set(got) - UNCOMPARED == set(want) - UNCOMPARED
    for key in set(want) - UNCOMPARED - {"failed_requests"}:
        assert got[key] == want[key], key
    records = [[v for _, v in sorted(r["failed_requests"].items(),
                                     key=lambda kv: int(kv[0]))]
               for r in (got, want)]
    assert records[0] == records[1]
    tiers = got["paging"]["tiers"]
    if flags.startswith("tiers") or flags == "tenants-tiers":
        assert tiers["tiered"] and got["paging"]["tier_speedup"] > 1.0
        assert (tiers["migrations"] > 0) == (flags == "tenants-tiers")
    if flags.startswith("faults"):
        f = got["faults"]
        assert f["injected"] == 3 and f["retried"] > 0
        assert f["quarantined"] == f["failed"] == 1
        assert records[0][0]["kind"] == "poisoned_block"
    if flags == "faults-offline":
        assert got["faults"]["offline_channels"] == [2]
        assert got["faults"]["evacuated"] > 0


@pytest.mark.parametrize("argv,needle", [
    (["--tiers", "ddr5:2,hbm:1"], "known kinds"),
    (["--faults", "offline:@3"], "bad fault-plan entry"),
    (["--tiers", "cxl:2", "--no-paging"], "drop --no-paging"),
])
def test_cli_tier_and_fault_errors_equal_reference(argv, needle,
                                                   monkeypatch, capsys):
    errs = []
    for main, extra in ((jserve.main, []), (tserve.main, ["--device", "cpu"])):
        monkeypatch.setattr(sys, "argv", ["serve", *argv, *extra])
        with pytest.raises(SystemExit) as e:
            main()
        assert e.value.code == 2
        errs.append(capsys.readouterr().err.strip().splitlines()[-1])
    assert errs[1] == errs[0]
    assert needle in errs[1]
