"""The harness's run on the CPU, at the SMOKE sizes of both families: the
closed loop on the program's engine, the readers, and the comparison
with the plain reference, which has to pass a sound run and fail each
fault that a serving cell can have, planted under the timed path.

``run.py`` itself refuses to run without a card; these tests call its
``run_cell`` with ``device="cpu"``, past the look for a card, and never
report a number as a device's."""

from __future__ import annotations

import subprocess
import sys
import time
from pathlib import Path
from unittest import mock

import pytest
import torch

from portbench import judge, spec
from portbench import run as bench
from portbench.run import run_cell

ROOT = Path(__file__).resolve().parents[2]

#: the SMOKE configs of ``repro_torch.configs`` in the configuration
#: files' keys
SMOKE = {
    "smollm-135m": dict(hidden_size=48, intermediate_size=128,
                        num_attention_heads=3, num_key_value_heads=1,
                        num_hidden_layers=2, vocab_size=256),
    "mixtral-8x7b-16L": dict(hidden_size=64, intermediate_size=128,
                             num_attention_heads=4, num_key_value_heads=1,
                             num_hidden_layers=2, vocab_size=256,
                             num_local_experts=4, rope_theta=10000.0),
}
#: the SMOKE mixtral's window is 16: at cache_len 16 it never engages,
#: as mixtral-8x7b's 4096 never does in its cell
#: limits at the SMOKE sizes, as the cells': smollm's widest token gap
#: (sound runs 0-0.0032 against the reference's eps 1e-5, the fp8
#: control 0.027-0.073) and block error (0.005-0.019 against 0.06-0.19);
#: mixtral's mean token gap (0-0.0002 against 0.012-0.061), since a
#: near-tied route that flips between bf16 and f32 can put one token's
#: gap at 0.2
LIMITS = {"smollm-135m": {"token_gap": 0.012, "kv_rel_err": 0.05},
          "mixtral-8x7b-16L": {"token_gap_mean": 0.005}}
SEED = 2**31 + 7


def smoke_cell(config: str, kv_requests: int | None = None) -> spec.Cell:
    """``config`` at its SMOKE sizes, a closed loop of 6 clients on 4
    slots. The paged blocks are judged in the dense family only (the
    cell that judges them, smollm-longgen, is dense): a MoE block's
    widest error carries the routes that flip between bf16 and f32, as
    mixtral's widest token gap does (PERF.md)."""
    if kv_requests is None:
        kv_requests = 0 if SMOKE[config].get("num_local_experts") else 2
    cfg = dict(spec.load_json(ROOT / f"portbench/configs/{config}.json"),
               smoke=True, **SMOKE[config])
    traffic = {"loop": "closed", "clients": 6,
               "prompt": {"dist": "loguniform", "min": 2, "max": 8},
               "output": {"dist": "loguniform", "min": 2, "max": 8},
               "first_output": {"dist": "uniform", "min": 2, "max": 8}}
    wl = {"config": config, "traffic": "smoke",
          "engine": dict(max_batch=4, cache_len=16, block_tokens=4,
                         hbm_blocks=5, prefill_chunk=4, megastep=2,
                         policy="hinted", pipeline_depth=1),
          "judge": {"kv_requests": kv_requests,
                    "limits": dict(LIMITS[config])}}
    bench = spec.load_json(ROOT / "BENCHMARK.json")
    e2e, per = spec.metrics_of(bench, "smollm-chat")
    return spec.Cell("smoke", 1, cfg, traffic, wl, tuple(e2e), tuple(per))


def run(cell, trace=False, seconds=2.5, control=False, tokens=40):
    """One run on the CPU after a 0.5 s ramp, judging ``tokens`` served
    tokens at least (the cells: ``run.RAMP_S``, ``judge.JUDGE_TOKENS``)."""
    with mock.patch.object(judge, "JUDGE_TOKENS", tokens), \
            mock.patch.object(bench, "RAMP_S", 0.5):
        return run_cell(cell, SEED, seconds, trace, "cpu",
                        time.perf_counter(), control=control)


@pytest.mark.parametrize("config", sorted(SMOKE))
@pytest.mark.parametrize("trace", [False, True])
def test_sound_run_is_correct(config, trace):
    out = run(smoke_cell(config), trace=trace, control=True)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0, out
    assert out["device"]["platform"] == "cpu"
    assert list(out)[-1] == "checks"
    names = set(out["metrics"])
    if trace:
        # the device readers find nothing to read without a card
        assert {"step_ms", "engine_plan_us_per_step", "queue_wait_ms",
                "paged_blocks_per_step", "mfu"} <= names
        assert not names & {"device_idle_share", "stream_roofline",
                            "decode_device_ms_per_step",
                            "engine_host_idle_ms_per_step"}
    else:
        assert {"tokens_per_s", "ttft_p95_ms", "tpot_p95_ms",
                "setup_s"} == names
    # the control fails what the program passes
    assert any(out["control"].get(k, 0.0) > v
               for k, v in LIMITS[config].items())


def _stale_cache(monkeypatch):
    """The decode step returns its state unchanged: the K/V it writes go
    to a copy, so later tokens attend to nothing new."""
    from repro_torch.models import layers

    real = layers.attn_decode_step

    def step(params, x, cache, pos, spec_):
        copy = {k: v.clone() for k, v in cache.items()}
        return real(params, x, copy, pos, spec_)[0], cache

    monkeypatch.setattr(layers, "attn_decode_step", step)


def _half_batch(monkeypatch):
    """Half of the batch left out: the second half of the rows get the
    logits of the first half."""
    from repro_torch.models import transformer

    real = transformer.decode_step

    def step(params, cfg, cache, tokens, pos):
        logits, cache = real(params, cfg, cache, tokens, pos)
        h = logits.shape[0] // 2
        return torch.cat([logits[:h], logits[:logits.shape[0] - h]]), cache

    monkeypatch.setattr(transformer, "decode_step", step)


def _altered_token(monkeypatch):
    """A token altered where it is produced: the logits shifted by one
    id, so the argmax picks the neighbour of the model's choice."""
    from repro_torch.models import transformer

    real = transformer.decode_step

    def step(params, cfg, cache, tokens, pos):
        logits, cache = real(params, cfg, cache, tokens, pos)
        return torch.roll(logits, 1, dims=-1), cache

    monkeypatch.setattr(transformer, "decode_step", step)


@pytest.mark.parametrize("config", sorted(SMOKE))
@pytest.mark.parametrize("fault", [_stale_cache, _half_batch,
                                   _altered_token])
def test_faults_under_the_timed_path_are_not_correct(config, fault,
                                                     monkeypatch):
    fault(monkeypatch)
    # every finished request judged: a fault on some rows cannot hide
    out = run(smoke_cell(config, kv_requests=0), tokens=10_000)
    assert not out["correct"]
    key = next(iter(LIMITS[config]))
    assert out["checks"][key]["value"] > LIMITS[config][key]


def _lost_page_out(monkeypatch):
    """The host tier loses what is paged out: the quantizing half of the
    stream writes zeros."""
    from repro_torch.kernels import ops

    real_q, real_d = ops.quant_kv_stream, ops.duplex_kv_stream

    def quant(x):
        q, s = real_q(x)
        return torch.zeros_like(q), s

    def duplex(in_q, in_scale, out_x, **kw):
        deq, q, s = real_d(in_q, in_scale, out_x, **kw)
        return deq, torch.zeros_like(q), s

    monkeypatch.setattr(ops, "quant_kv_stream", quant)
    monkeypatch.setattr(ops, "duplex_kv_stream", duplex)


def _no_write_through(monkeypatch):
    """The pool's write-through is skipped: blocks stay as installed."""
    from repro_torch.serve import kv_pool

    monkeypatch.setattr(kv_pool.PagedKVPool, "write_staged",
                        lambda self, blocks, staged, step: None)


@pytest.mark.parametrize("fault", [_lost_page_out, _no_write_through])
def test_paging_faults_are_not_correct(fault, monkeypatch):
    fault(monkeypatch)
    cell = smoke_cell("smollm-135m", kv_requests=4)
    # requests of 4-8 blocks in a pool of one HBM block a row: every
    # older block lives on the host tier
    cell.workload["engine"].update(hbm_blocks=4, cache_len=32)
    for key in ("prompt", "output", "first_output"):
        cell.traffic[key].update(min=8, max=16)
    out = run(cell, seconds=1.5)
    assert not out["correct"]
    assert out["checks"]["kv_rel_err"]["value"] > \
        LIMITS["smollm-135m"]["kv_rel_err"]


def test_cli_refuses_without_a_card(tmp_path):
    """No card: exit 2, nothing on standard output. A directory with
    only BENCHMARK.json and the benchmark's folder: no result either."""
    assert not torch.cuda.is_available()
    cmd = [sys.executable, "portbench/run.py", "--workload", "smollm-chat",
           "--seed", "1", "--seconds", "1", "--trace", "0"]
    out = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 2 and out.stdout == ""
    import shutil
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    alone = subprocess.run(cmd, cwd=tmp_path, capture_output=True,
                           text=True, timeout=300)
    assert alone.returncode != 0 and alone.stdout == ""
