"""The port's hint tree against the JAX package's for what training
uses: ``HintTree.remove``, ``to_json`` / ``from_json`` and
``default_training_hints``, compared as JSON text and by resolution of
every scope."""

import pytest

torch = pytest.importorskip("torch")

from repro.core import hints as JH  # noqa: E402
from repro_torch.core import hints as TH  # noqa: E402

PROBES = ("/", "/train", "/train/fwd", "/train/bwd", "/train/grads",
          "/train/opt_offload", "/train/opt_offload/m", "/train/checkpoint",
          "/serve/kv_cache/page_in", "/serve/redis/seq/read", "/nowhere")


def _resolved(tree, path):
    return tuple(getattr(tree.resolve(path).resolved(), f)
                 for f in TH.MemoryHint.FIELDS)


def _same(t, j):
    assert t.to_json() == j.to_json()
    assert list(t.paths()) == list(j.paths())
    for p in PROBES:
        assert _resolved(t, p) == _resolved(j, p), p


def test_default_training_hints_equal_reference():
    t, j = TH.default_training_hints(), JH.default_training_hints()
    _same(t, j)
    assert t.resolve("/train/opt_offload").read_fraction == 0.5


@pytest.mark.parametrize("make", ["default_training_hints",
                                  "default_serving_hints"])
def test_json_round_trip_equals_reference(make):
    t, j = getattr(TH, make)(), getattr(JH, make)()
    tt, jj = TH.HintTree.from_json(t.to_json()), \
        JH.HintTree.from_json(j.to_json())
    _same(tt, jj)
    _same(tt, t)
    # each package reads the other's text
    _same(TH.HintTree.from_json(j.to_json()), j)


@pytest.mark.parametrize("path", ["/train/opt_offload", "/train", "/",
                                  "/not/set"])
def test_remove_equals_reference(path):
    t, j = TH.default_training_hints(), JH.default_training_hints()
    t.set("/", TH.MemoryHint(priority=0.3))
    j.set("/", JH.MemoryHint(priority=0.3))
    t.remove(path)
    j.remove(path)
    _same(t, j)


def test_from_json_refuses_an_unknown_tier_like_reference():
    text = '{"/x": {"tier": "nvme"}}'
    with pytest.raises(ValueError, match="unknown tier"):
        TH.HintTree.from_json(text)
    with pytest.raises(ValueError, match="unknown tier"):
        JH.HintTree.from_json(text)
