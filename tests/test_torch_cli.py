"""The port's serve CLI against the reference CLI: under each of the six
admission policies, for the other dense configs, the MoE configs
mixtral-8x7b and kimi-k2-1t-a32b and the nested-cache families
zamba2-7b and whisper-base (``--arch``), under the
tiered host pool and fault plans
(``--tiers``, ``--no-tier-migrate``, ``--faults``, with tenants too), and
across a crash and its restore (``--faults crash:@S --snapshot-dir
--snapshot-every``, exit 3, then ``--restore``),
both ``main()``s run in-process on the SMOKE config (``--device cpu``
for the port) and print the same JSON report, field for field; the
parse-time errors of ``--tiers``, ``--faults`` and the snapshot flags
read the same; under
``--trace`` both report the same trace summary (bar the path and the
host-clock span times) and export a Perfetto file. Left
out of the comparison: the wall clock (``wall_s``, ``tok_s``) and the
port's ``device`` field, which the reference's report
does not have. The tokens themselves are not in the report (each CLI
draws its own random weights). ``--mesh 1,1`` serves sharded in both and
reports the same; a mesh larger than the devices and a malformed one are
refused alike."""

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


@pytest.mark.parametrize("flags", ["plain", "tenants-tiers", "faults-offline"])
def test_cli_trace_equals_reference(flags, monkeypatch, tmp_path):
    """``--trace OUT.JSON``: the report's ``trace`` field equals the
    reference CLI's apart from its ``path`` and the host-clock span
    times (``phase_us``' ``*_us``; their counts are compared)."""
    extra = [] if flags == "plain" else TIER_FAULT_FLAGS[flags]
    argv = ["serve", "--gen", "12", "--no-warmup", *extra]
    reports = []
    for main, side in ((jserve.main, []), (tserve.main, ["--device", "cpu"])):
        path = str(tmp_path / f"{len(reports)}.json")
        reports.append(_report(main, argv + side + ["--trace", path],
                               monkeypatch))
        doc = json.load(open(path))
        assert doc["otherData"]["modelled_horizon_us"] == \
            reports[-1]["trace"]["model_us"]
    want, got = reports
    assert got["trace"]["path"].endswith("1.json")
    for rep in reports:
        rep["trace"].pop("path")
        phases = rep["trace"]["phase_us"]
        assert {"plan_us", "dispatch_us", "reconcile_us"} <= set(phases)
        for key in [k for k in phases if k.endswith("_us")]:
            phases[key] = None
    for key in set(want) - UNCOMPARED - {"failed_requests"}:
        assert got[key] == want[key], key
    assert got["trace"]["duplex_util"] and got["trace"]["events"] > 0


def _run(main, argv, monkeypatch) -> tuple[int, dict]:
    """main()'s exit code and the JSON of its last line."""
    monkeypatch.setattr(sys, "argv", argv)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        code = main()
    return code, json.loads(out.getvalue().strip().splitlines()[-1])


@pytest.mark.parametrize("flags", [
    ["--no-warmup"],
    ["--tiers", "ddr5:2,cxl:2", "--megastep", "4"]])
def test_cli_crash_then_restore_equals_reference(flags, monkeypatch,
                                                 tmp_path):
    """``--faults crash:@S --snapshot-dir D --snapshot-every 2``: both
    CLIs exit 3 with the same crash report (a resumable snapshot, the
    same newest cut and journal length); the same flags with
    ``--restore`` then print the same report field for field, its
    ``restore`` section included (the warmup of the second case must
    not crash: its injector is disarmed)."""
    runs = []
    for main, side in ((jserve.main, []), (tserve.main, ["--device", "cpu"])):
        d = str(tmp_path / f"snap{len(runs)}")
        argv = ["serve", "--requests", "4", "--gen", "12", "--faults",
                "crash:@10", "--snapshot-dir", d, "--snapshot-every", "2",
                *flags, *side]
        code, crash = _run(main, argv, monkeypatch)
        assert code == 3
        assert crash["snapshot"].pop("dir") == d
        code, restored = _run(main, argv + ["--restore"], monkeypatch)
        assert code == 0
        runs.append((crash, restored))
    (jcrash, want), (tcrash, got) = runs
    assert tcrash == jcrash
    assert tcrash["error"]["type"] == "CrashFault"
    assert tcrash["snapshot"]["resumable"]
    assert set(got) - UNCOMPARED == set(want) - UNCOMPARED
    for key in set(want) - UNCOMPARED:
        assert got[key] == want[key], key
    assert got["restore"]["restored_step"] == \
        tcrash["snapshot"]["newest_valid"]
    assert got["generated_tokens"] == 48


@pytest.mark.parametrize("argv", [
    ["--snapshot-every", "2"],
    ["--snapshot-every", "2", "--snapshot-dir", "D", "--no-paging"],
    ["--restore"],
    ["--tenants", "redis", "--snapshot-every", "2", "--snapshot-dir", "D"],
])
def test_cli_snapshot_errors_equal_reference(argv, monkeypatch, capsys):
    errs = []
    for main, extra in ((jserve.main, []), (tserve.main, ["--device", "cpu"])):
        monkeypatch.setattr(sys, "argv", ["serve", *argv, *extra])
        with pytest.raises(SystemExit) as e:
            main()
        assert e.value.code == 2
        errs.append(capsys.readouterr().err.strip().splitlines()[-1])
    assert errs[1] == errs[0]
    assert "snapshot" in errs[1] or "--restore" in errs[1]


@pytest.mark.parametrize("arch", ["llama3.2-3b", "qwen2.5-14b",
                                  "stablelm-3b"])
def test_cli_dense_configs_equal_reference(arch, monkeypatch):
    """``--arch`` for the three other dense configs (SMOKE): the same
    report field for field — counts, paging stats, ``duplex_speedup``."""
    argv = ["serve", "--arch", arch, "--requests", "4", "--gen", "6",
            "--no-warmup"]
    want = _report(jserve.main, argv, monkeypatch)
    got = _report(tserve.main, argv + ["--device", "cpu"], monkeypatch)
    assert set(got) - UNCOMPARED == set(want) - UNCOMPARED
    for key in set(want) - UNCOMPARED:
        assert got[key] == want[key], key
    assert got["arch"] == arch and got["generated_tokens"] == 24
    assert got["paging"]["paged"] and got["paging"]["page_outs"] > 0


@pytest.mark.parametrize("extra", [[], ["--tiers", "ddr5:2,cxl:2"]])
@pytest.mark.parametrize("arch", ["zamba2-7b", "whisper-base"])
def test_cli_nested_cache_archs_equal_reference(arch, extra, monkeypatch):
    """``--arch zamba2-7b`` and ``--arch whisper-base`` at the defaults
    (SMOKE): paging gated off by the cache family, and the reference
    CLI's report field for field: 8 requests, 128 tokens in 40 steps, 16
    host dispatches, 1 blocked boundary. ``--tiers`` configures a pool
    that is not there, in both CLIs alike."""
    argv = ["serve", "--arch", arch, "--no-warmup", *extra]
    want = _report(jserve.main, argv, monkeypatch)
    got = _report(tserve.main, argv + ["--device", "cpu"], monkeypatch)
    assert set(got) - UNCOMPARED == set(want) - UNCOMPARED
    for key in set(want) - UNCOMPARED:
        assert got[key] == want[key], key
    assert got["arch"] == arch and got["paging"]["paged"] is False
    assert (got["requests"], got["generated_tokens"], got["steps"],
            got["host_dispatches"], got["host_blocked"]) == (
        8, 128, 40, 16, 1)


@pytest.mark.parametrize("flags", [
    ["--tenants", "redis"],
    ["--faults", "poison:2@8"],
    ["--snapshot-dir", "SNAP", "--snapshot-every", "2"],
])
@pytest.mark.parametrize("arch", ["zamba2-7b", "whisper-base"])
def test_cli_nested_cache_arch_errors_equal_reference(arch, flags,
                                                      monkeypatch, tmp_path):
    """Tenants, fault plans and snapshots need the paged pool, which these
    cache families gate off: both CLIs raise the same ValueError when the
    engine is built."""
    flags = [str(tmp_path / f) if f == "SNAP" else f for f in flags]
    errs = []
    for main, extra in ((jserve.main, []), (tserve.main, ["--device", "cpu"])):
        monkeypatch.setattr(sys, "argv", ["serve", "--arch", arch,
                                          "--no-warmup", *flags, *extra])
        with pytest.raises(ValueError) as e:
            with contextlib.redirect_stdout(io.StringIO()):
                main()
        errs.append(str(e.value))
    assert errs[1] == errs[0]
    assert "paging disabled (or a non-pageable cache family)" in errs[1]


@pytest.mark.parametrize("arch,extra", [
    ("mixtral-8x7b", []), ("kimi-k2-1t-a32b", []),
    ("mixtral-8x7b", ["--tiers", "ddr5:2,cxl:2"]),
    ("mixtral-8x7b", ["--faults", "poison:3@5"])],
    ids=["mixtral", "kimi", "mixtral-tiers", "mixtral-faults"])
def test_cli_moe_archs_equal_reference(arch, extra, monkeypatch):
    """``--arch`` for the MoE configs (SMOKE) through the paged pool: the
    reference CLI's report field for field. At the defaults both give 23
    page-ins, 39 page-outs, 22 kernel calls, ``duplex_speedup`` 1.233,
    16 host dispatches and 1 blocked boundary."""
    argv = ["serve", "--arch", arch, "--no-warmup", *extra]
    want = _report(jserve.main, argv, monkeypatch)
    got = _report(tserve.main, argv + ["--device", "cpu"], monkeypatch)
    assert set(got) - UNCOMPARED == set(want) - UNCOMPARED
    for key in set(want) - UNCOMPARED - {"failed_requests"}:
        assert got[key] == want[key], key
    records = [[v for _, v in sorted(r.get("failed_requests", {}).items(),
                                     key=lambda kv: int(kv[0]))]
               for r in (got, want)]
    assert records[0] == records[1]
    assert got["arch"] == arch and got["paging"]["paged"] is True
    if not extra:
        p = got["paging"]
        assert (p["page_ins"], p["page_outs"], p["kernel_calls"],
                p["duplex_speedup"], got["host_dispatches"],
                got["host_blocked"]) == (23, 39, 22, 1.233, 16, 1)
    if extra[:1] == ["--tiers"]:
        assert got["paging"]["tiers"]["tiered"]
    if extra[:1] == ["--faults"]:
        assert got["faults"]["injected"] == 1


@pytest.mark.parametrize("extra", [[], ["--tiers", "ddr5:2,cxl:2",
                                        "--tenants", "redis"]],
                         ids=["alone", "tiers-tenant"])
def test_cli_mesh_equals_reference(extra, monkeypatch):
    """``--mesh 1,1`` serves through ``ShardedServeEngine`` in both CLIs:
    the same report field for field (``mesh``, and the paging stats'
    ``mesh``, ``ici`` and per-shard tier stats), and the ``mesh`` line."""
    argv = ["serve", "--gen", "8", "--no-warmup", "--mesh", "1,1", *extra]
    reports, lines = [], []
    for main, side in ((jserve.main, []), (tserve.main, ["--device", "cpu"])):
        monkeypatch.setattr(sys, "argv", argv + side)
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            assert main() == 0
        text = out.getvalue().strip().splitlines()
        reports.append(json.loads(text[-1]))
        lines.append([t for t in text if t.startswith("mesh ")])
    want, got = reports
    assert set(got) - UNCOMPARED == set(want) - UNCOMPARED
    for key in set(want) - UNCOMPARED:
        assert got[key] == want[key], key
    assert got["mesh"] == got["paging"]["mesh"] == {"data": 1, "model": 1}
    assert got["paging"]["ici"]["bytes"] == 0.0
    assert lines[1] == lines[0] == [
        "mesh 1x1 (data x model): 0.00 MB over ICI in 0 collectives "
        "(0.0 us modelled)"]


@pytest.mark.parametrize("mesh", ["2,2", "0,1", "2"])
def test_cli_mesh_errors_equal_reference(mesh, monkeypatch, capsys):
    """A mesh larger than the devices exits 2 in both CLIs (``--devices
    1``: one device, as the port counts on the CPU, whatever number of
    JAX host devices this process was started with); a malformed one is
    refused at parse time with the same message."""
    errs = []
    for main, extra in ((jserve.main, []), (tserve.main, ["--device", "cpu"])):
        monkeypatch.setattr(sys, "argv", ["serve", "--mesh", mesh,
                                          "--devices", "1", *extra])
        with pytest.raises(SystemExit) as e:
            main()
        assert e.value.code == 2
        errs.append(capsys.readouterr().err.strip().splitlines()[-1])
    if mesh == "2,2":
        # the remedy differs: the reference forces host devices, the port
        # builds ranks that share a device
        head = "--mesh 2,2 needs 4 devices but only 1 are available"
        assert all(head in e for e in errs)
    else:
        assert errs[1] == errs[0]
        assert "two positive axis sizes" in errs[1]
