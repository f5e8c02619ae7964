"""The port's data pipeline (``repro_torch.data``) against the JAX
package's: ``make_batch`` bit-equal over seeds, steps, ranks and
``dp_size``; the reference's determinism, sharding and resume cases on
the port; ``device_batch`` on the CPU."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.data import DataConfig as JDataConfig  # noqa: E402
from repro.data import make_batch as jmake_batch  # noqa: E402
from repro_torch.data import (DataConfig, SyntheticLMData,  # noqa: E402
                              device_batch, make_batch)


def _cfg(gb=8):
    return DataConfig(vocab=1000, seq_len=64, global_batch=gb, seed=3)


@pytest.mark.parametrize("seed,vocab,seq_len,mean_doc", [
    (0, 100, 16, 256), (3, 1000, 64, 256), (7, 49152, 128, 8),
    (11, 65536, 33, 1)])
def test_make_batch_bit_equal_to_reference(seed, vocab, seq_len, mean_doc):
    kw = dict(vocab=vocab, seq_len=seq_len, global_batch=8, seed=seed,
              mean_doc_len=mean_doc)
    for step in (0, 1, 5, 1000):
        for dp_size in (1, 2, 4, 8):
            for rank in range(dp_size):
                got = make_batch(DataConfig(**kw), step, rank, dp_size)
                want = jmake_batch(JDataConfig(**kw), step, rank, dp_size)
                assert set(got) == set(want) == {"tokens", "labels"}
                for key in got:
                    assert got[key].dtype == want[key].dtype == np.int32
                    np.testing.assert_array_equal(got[key], want[key])


class TestDeterminism:
    def test_same_step_same_batch(self):
        a = make_batch(_cfg(), step=5)
        b = make_batch(_cfg(), step=5)
        np.testing.assert_array_equal(a["tokens"], b["tokens"])

    def test_different_steps_differ(self):
        a = make_batch(_cfg(), step=5)
        b = make_batch(_cfg(), step=6)
        assert not np.array_equal(a["tokens"], b["tokens"])

    def test_labels_are_next_token(self):
        b = make_batch(_cfg(), step=0)
        assert b["tokens"].shape == b["labels"].shape == (8, 64)
        np.testing.assert_array_equal(b["tokens"][:, 1:],
                                      b["labels"][:, :-1])


class TestSharding:
    def test_ranks_partition_global_batch(self):
        cfg = _cfg(gb=8)
        full = make_batch(cfg, step=2, dp_rank=0, dp_size=1)
        parts = [make_batch(cfg, step=2, dp_rank=r, dp_size=4)
                 for r in range(4)]
        np.testing.assert_array_equal(
            full["tokens"], np.concatenate([p["tokens"] for p in parts]))

    def test_elastic_resharding_losslessly_readdresses(self):
        cfg = _cfg(gb=8)
        before = make_batch(cfg, step=7, dp_rank=0, dp_size=1)
        after = [make_batch(cfg, step=7, dp_rank=r, dp_size=2)
                 for r in range(2)]
        np.testing.assert_array_equal(
            before["tokens"], np.concatenate([a["tokens"] for a in after]))

    def test_indivisible_raises(self):
        with pytest.raises(ValueError):
            make_batch(_cfg(gb=8), step=0, dp_rank=0, dp_size=3)


class TestIterator:
    def test_resume_from_step(self):
        cfg = _cfg()
        it = SyntheticLMData(cfg, start_step=10)
        first = next(it)
        np.testing.assert_array_equal(first["tokens"],
                                      make_batch(cfg, 10)["tokens"])
        assert it.step == 11
        np.testing.assert_array_equal(it.peek(3)["labels"],
                                      make_batch(cfg, 3)["labels"])

    def test_token_range(self):
        b = make_batch(_cfg(), step=0)
        assert b["tokens"].min() >= 0
        assert b["tokens"].max() < 1000


def test_device_batch_on_the_cpu():
    raw = make_batch(_cfg(gb=2), step=1)
    extra = {"frames": torch.zeros((2, 4, 8))}
    out = device_batch(raw, extra, "cpu")
    assert set(out) == {"tokens", "labels", "frames"}
    assert out["tokens"].dtype == torch.int32
    assert out["tokens"].device.type == "cpu"
    np.testing.assert_array_equal(out["labels"].numpy(), raw["labels"])
    assert out["frames"] is extra["frames"]
