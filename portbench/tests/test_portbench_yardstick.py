"""The yardstick's own arithmetic, on the CPU: the traffic, the tails and
rates, the byte and FLOP counts, and the discovery of files by name."""

from __future__ import annotations

import json
import shutil
import types
from pathlib import Path

import numpy as np
import pytest

from portbench import devtrace, spec, timeline, traffic
from portbench.families import transformer as fam

ROOT = Path(__file__).resolve().parents[2]
BENCH = spec.load_json(ROOT / "BENCHMARK.json")
CELLS = [w["name"] for w in BENCH["workloads"]]


@pytest.mark.parametrize("cell", CELLS)
def test_traffic_repeats_and_matches_the_cell(cell):
    c = spec.load_cell(cell)
    tr = c.traffic
    a = traffic.ClosedLoop(tr, fam.vocab(c.config), 2**31 + 11)
    b = traffic.ClosedLoop(tr, fam.vocab(c.config), 2**31 + 11)
    other = traffic.ClosedLoop(tr, fam.vocab(c.config), 5)
    assert a.clients == tr["clients"]
    for k in range(3):
        for client in (0, a.clients - 1):
            pa, na = a.request(client, k)
            pb, nb = b.request(client, k)
            assert np.array_equal(pa, pb) and na == nb
            assert pa.dtype == np.int32
            assert pa.min() >= 0 and pa.max() < fam.vocab(c.config)
        plen, outs = a.sizes(k)
        oplen, oouts = other.sizes(k)
        # every seed sends the same sizes to the same clients; a round's
        # sizes are the distributions' stratified quantiles
        assert np.array_equal(plen, oplen) and np.array_equal(outs, oouts)
        first = tr["first_output"] if k == 0 else tr["output"]
        assert sorted(plen.tolist()) == traffic.quantiles(
            tr["prompt"], a.clients).tolist()
        assert sorted(outs.tolist()) == traffic.quantiles(
            first, a.clients).tolist()
        assert plen.min() >= tr["prompt"]["min"]
        assert plen.max() <= tr["prompt"]["max"]
        dist = tr["first_output"] if k == 0 else tr["output"]
        assert outs.min() >= dist["min"] and outs.max() <= dist["max"]
    assert not np.array_equal(a.sizes(1)[0], a.sizes(2)[0])
    assert not np.array_equal(a.request(0, 0)[0][:8],
                              other.request(0, 0)[0][:8])
    assert a.max_total <= c.workload["engine"]["cache_len"]


@pytest.mark.parametrize("cell", CELLS)
def test_traffic_follows_its_source(cell):
    """Every traffic file names a public source and the figures it takes
    from it; the schedule of sizes meets each figure, or the cut of it
    that ``reduced`` states with its reason."""
    tr = spec.load_cell(cell).traffic
    assert tr["source"] and tr["deployment"] and tr["assumed"]
    assert tr["figures"]
    for key, figure in tr["figures"].items():
        cut = tr["reduced"].get(key)
        if cut is not None:
            assert cut["why"]
            figure = cut["to"]
        kind, _, stat = key.rpartition("_")
        if kind not in ("prompt", "output"):
            continue
        q = traffic.quantiles(tr[kind], tr["clients"])
        got = {"mean": np.mean, "median": np.median}[stat](q)
        assert got == pytest.approx(figure, rel=0.02), (key, got)


def test_quantiles_follow_the_distribution():
    q = traffic.quantiles({"dist": "loguniform", "min": 16, "max": 256}, 4)
    # (i + 0.5) / 4 of the way from log 16 to log 256
    assert q.tolist() == [23, 45, 91, 181]
    u = traffic.quantiles({"dist": "uniform", "min": 1024, "max": 1536}, 4)
    assert u.tolist() == [1088, 1216, 1344, 1472]


def _synthetic(stall: float = 0.0, slow: float = 0.0):
    """Four requests of a 10 s window. ``stall`` delays the third one's
    first token and everything after it; ``slow`` its completion."""
    R = timeline.Rec
    return [R(0, 8, 11, submit=0.0, admit=0.0, first=0.5, done=2.5,
              tokens=11),
            R(1, 8, 5, submit=0.0, admit=1.0, first=1.5, done=2.5,
              tokens=5),
            R(0, 8, 21, submit=2.5, admit=2.5, first=3.0 + stall,
              done=7.0 + stall + slow, tokens=21),
            R(1, 8, 30, submit=2.5, admit=4.0, first=4.5, done=None,
              tokens=1)]


def _ctx(recs, t_end=10.0, tokens=38):
    w = types.SimpleNamespace(recs=recs, t_end=t_end, seconds=t_end,
                              tokens=tokens, steps=100, flops=0.0,
                              page_ins=0, page_outs=0, plan_us=None)
    return types.SimpleNamespace(window=w, tail=None, setup_s=1.0)


def test_end_to_end_metrics_on_a_synthetic_timeline():
    read = {n: spec.metric_reader(n) for n in
            ("tokens_per_s", "ttft_p95_ms", "tpot_p95_ms",
             "queue_wait_ms")}
    ctx = _ctx(_synthetic())
    assert read["tokens_per_s"](ctx) == pytest.approx(3.8)
    # first-token waits 0.5, 1.5, 0.5, 2.0
    assert read["ttft_p95_ms"](ctx) == pytest.approx(2000.0)
    # (2.5-0.5)/10 = 0.2, (2.5-1.5)/4 = 0.25, (7-3)/20 = 0.2
    assert read["tpot_p95_ms"](ctx) == pytest.approx(250.0)
    assert read["queue_wait_ms"](ctx) == pytest.approx(
        (0 + 1.0 + 0 + 1.5) / 4 * 1e3)
    # a stall before the third request's first token moves the tail
    assert read["ttft_p95_ms"](_ctx(_synthetic(stall=4.0))) == \
        pytest.approx(4500.0)
    # one that lasts past the window counts the wait so far
    assert read["ttft_p95_ms"](_ctx(_synthetic(stall=9.0))) == \
        pytest.approx(7500.0)
    # a slow decode moves the time a token: (10 - 3) / 20
    assert read["tpot_p95_ms"](_ctx(_synthetic(slow=3.0))) == \
        pytest.approx(350.0)
    assert read["tokens_per_s"](_ctx(_synthetic(), tokens=18)) == \
        pytest.approx(1.8)


def test_the_ramp_stays_out_of_the_window():
    """Requests of the ramp (negative times) count in no tail of first
    tokens and no queue wait; one of them that completes in the window
    counts in the time a token."""
    R = timeline.Rec
    ramp = [R(2, 8, 11, submit=-3.0, admit=-3.0, first=-0.5, done=1.5,
              tokens=11),
            R(3, 8, 5, submit=-4.0, admit=-1.0, first=-0.4, done=-0.1,
              tokens=5)]
    recs = _synthetic() + ramp
    assert sorted(timeline.ttft_values(recs, 10.0)) == \
        sorted(timeline.ttft_values(_synthetic(), 10.0))
    assert timeline.queue_waits(recs, 10.0) == \
        timeline.queue_waits(_synthetic(), 10.0)
    # (1.5 - -0.5) / 10 = 0.2 joins; the one done before 0 does not
    assert len(timeline.tpot_values(recs, 10.0)) == \
        len(timeline.tpot_values(_synthetic(), 10.0)) + 1


def test_opening_the_window_shifts_the_clock():
    from portbench.loop import Driver

    clock = iter([10.0, 12.5, 13.0]).__next__
    d = Driver.__new__(Driver)
    d.clock, d.t0 = clock, clock()
    d.recs = [timeline.Rec(0, 4, 4, submit=0.0, admit=0.5, first=2.0)]
    d.tokens, d.flops, d.history = 7, 3.0, [(2.0, 7)]
    d.open_window()
    r = d.recs[0]
    assert (r.submit, r.admit, r.first, r.done) == (-2.5, -2.0, -0.5, None)
    assert (d.tokens, d.flops, d.history) == (0, 0.0, [])
    assert d.now() == pytest.approx(0.5)


def test_p95_is_nearest_rank():
    assert timeline.p95(range(1, 101)) == 95
    assert timeline.p95([3.0]) == 3.0
    assert timeline.p95([]) is None
    assert timeline.passes(10, 4, 0) == 4
    assert timeline.passes(10, 10, 1) == 10
    assert timeline.passes(10, 10, 5) == 14


def test_stream_bytes_by_hand():
    # 3 blocks in and 2 out of 16 tokens x 11520: per block 16 x 11520
    # int8 + 16 f32 scales + 16 x 11520 bf16
    assert devtrace.stream_bytes(3, 2, 16, 11520) == 5 * (
        16 * 11520 + 16 * 4 + 16 * 11520 * 2)


def test_flops_by_hand():
    smol = spec.load_json(ROOT / "portbench/configs/smollm-135m.json")
    # 30 x (576x576 x 2 + 576x192 x 2 + 3 x 576x1536) + 576 x 49152
    assert fam.matmul_params(smol) == 134_479_872
    # positions 0..9: 2 x params x 10 + 4 x 30 layers x 9 heads x 64 x
    # (1 + ... + 10)
    assert fam.range_flops(smol, 0, 10) == 2_693_399_040
    mix = spec.load_json(ROOT / "portbench/configs/mixtral-8x7b-16L.json")
    # 16 x (4096x4096 x 2 + 4096x1024 x 2 + 4096 x 8 + 2 x 3 x
    # 4096x14336) + 4096 x 32000
    assert fam.matmul_params(mix) == 6_439_829_504
    # positions 100, 101: contexts 101 and 102
    assert fam.range_flops(mix, 100, 102) == \
        2 * 6_439_829_504 * 2 + 4 * 16 * 32 * 128 * 203
    windowed = dict(mix, sliding_window=100)
    assert fam.range_flops(windowed, 100, 102) == \
        2 * 6_439_829_504 * 2 + 4 * 16 * 32 * 128 * 200
    assert fam.kv_dims(smol) == 11520 and fam.kv_dims(mix) == 32768


def test_union_and_gaps():
    iv = [(0, 10), (5, 20), (30, 40)]
    assert devtrace.union_ns(iv) == 30
    assert devtrace.gaps(iv, 0, 50) == [(20, 30), (40, 50)]
    assert devtrace.STREAM_KERNEL.search("void quant_kernel<1>(x)")
    assert devtrace.STREAM_KERNEL.search("dequant_kernel<0>")
    assert not devtrace.STREAM_KERNEL.search("void squant_kernelx()")


def test_files_dropped_into_their_folders_are_found(tmp_path):
    """A new cell, configuration, traffic mix and metric are files only:
    the copy of the benchmark with them added finds each by name."""
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    conf = json.loads((ROOT / "portbench/configs/smollm-135m.json")
                      .read_text())
    conf["name"] = "smollm-135m-b"
    (tmp_path / "portbench/configs/smollm-135m-b.json").write_text(
        json.dumps(conf))
    tr = json.loads((ROOT / "portbench/traffic/lmsys-chat-c80.json")
                    .read_text())
    tr["clients"] = 70
    (tmp_path / "portbench/traffic/chat-c70.json").write_text(json.dumps(tr))
    wl = json.loads((ROOT / "portbench/workloads/smollm-chat.json")
                    .read_text())
    wl.update(config="smollm-135m-b", traffic="chat-c70")
    (tmp_path / "portbench/workloads/smollm-chat-b.json").write_text(
        json.dumps(wl))
    (tmp_path / "portbench/metrics/tokens_per_step.py").write_text(
        "def read(ctx):\n    return ctx.window.tokens / ctx.window.steps\n")
    bench["configs"].append(dict(bench["configs"][0], name="smollm-135m-b",
                                 file="portbench/configs/smollm-135m-b.json"))
    bench["workloads"].append({"name": "smollm-chat-b",
                               "config": "smollm-135m-b",
                               "traffic": "chat-c70", "chips": 1,
                               "why": "a cell added as files"})
    bench["per_layer"].append({"name": "tokens_per_step", "unit": "tokens",
                               "better": "higher", "source": "host_clock",
                               "layer": "engine", "moves": "tokens_per_s"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = spec.load_cell("smollm-chat-b", root=tmp_path)
    assert cell.config["name"] == "smollm-135m-b"
    assert cell.traffic["clients"] == 70
    assert "tokens_per_step" in [m.name for m in cell.per_layer]
    read = spec.metric_reader("tokens_per_step", root=tmp_path)
    assert read(_ctx([], tokens=50)) == 0.5
    # the cells already there are unchanged
    old = spec.load_cell("smollm-chat", root=tmp_path)
    assert "tokens_per_step" in [m.name for m in old.per_layer]
    assert old.traffic["clients"] == 80
