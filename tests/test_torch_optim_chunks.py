"""The optimizers' chunked update (``adamw.CHUNK`` elements of a leaf at a
time, each result written in place into its output slice).

* On plain tensors the chunks change no value: the device AdamW and the
  host-offloaded AdamW with chunks of a few hundred elements equal, bit
  for bit, the same steps with every leaf in one chunk.
* On a dry-run's sharded leaves (DTensors) the update moves no bytes of
  its own: every collective of ``adamw_update`` is one that the global
  norm's clip already makes. A flat view of a sharded leaf would gather
  it onto every device, as the first chunked version did (the mixtral-8x7b
  ``train_4k`` multipod cell's predicted peak rose from 23 GB to 647 GB).
"""

import pytest
import torch

from repro_torch.launch.mesh import device_mesh
from repro_torch.models.layers import tree_leaves, tree_map
from repro_torch.optim import adamw
from repro_torch.optim.host_offload import HostOffloadAdamW

WHOLE = 1 << 40


def _tree(gen, dtype):
    mk = lambda *s: torch.randn(s, generator=gen).to(dtype)  # noqa: E731
    return {"stack": mk(3, 40, 70), "norm": mk(70), "head": {"w": mk(9, 33)}}


def _steps(opt: str, params, grads, n: int = 3):
    cfg = adamw.AdamWConfig(warmup_steps=1)
    if opt == "device":
        state = adamw.adamw_init(params)
        for _ in range(n):
            params, state, _ = adamw.adamw_update(cfg, params, grads, state)
        return [*tree_leaves(params), *tree_leaves(state["m"]),
                *tree_leaves(state["v"])]
    host = HostOffloadAdamW(cfg)
    state = host.init(params)
    for _ in range(n):
        params, state, _ = host.update(params, grads, state)
    return [*tree_leaves(params), *tree_leaves(host._m),
            *tree_leaves(host._v)]


@pytest.mark.parametrize("opt", ["device", "host"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_chunks_change_no_value(monkeypatch, opt, dtype):
    gen = torch.Generator().manual_seed(0)
    params, grads = _tree(gen, dtype), _tree(gen, dtype)
    monkeypatch.setattr(adamw, "CHUNK", WHOLE)
    whole = _steps(opt, params, grads)
    monkeypatch.setattr(adamw, "CHUNK", 257)
    chunked = _steps(opt, params, grads)
    assert len(whole) == len(chunked)
    for a, b in zip(whole, chunked):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_sharded_update_moves_nothing_of_its_own(monkeypatch):
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.distributed.tensor.debug import CommDebugMode

    mesh = device_mesh((2, 2), ("data", "model"))
    gen = torch.Generator().manual_seed(1)
    layout = {"w": ((8, 32), [Replicate(), Shard(1)]),
              "e": ((16, 8), [Shard(0), Replicate()]),
              "b": ((32,), [Replicate(), Replicate()])}

    def tree(fill):
        return {k: DTensor.from_local(fill(s), mesh, pl, run_check=False)
                for k, (s, pl) in layout.items()}

    params = tree(lambda s: torch.randn(s, generator=gen))
    grads = tree(lambda s: torch.randn(s, generator=gen))
    state = {"m": tree(torch.zeros), "v": tree(torch.zeros),
             "step": torch.zeros((), dtype=torch.int32)}
    cfg = adamw.AdamWConfig(warmup_steps=1)
    monkeypatch.setattr(adamw, "CHUNK", 16)
    norm_only, step = CommDebugMode(), CommDebugMode()
    with norm_only:
        adamw.clip_by_global_norm(grads, cfg.clip_norm)
    with step:
        new, new_state, _ = adamw.adamw_update(cfg, params, grads, state)
    assert step.get_comm_counts() == norm_only.get_comm_counts()
    for t, ref in zip(tree_leaves(new), tree_leaves(params)):
        assert isinstance(t, DTensor) and t.placements == ref.placements
    for t, ref in zip(tree_leaves(new_state["m"]), tree_leaves(params)):
        assert t.placements == ref.placements
    assert tree_map(lambda t: t.shape, new) == tree_map(lambda t: t.shape,
                                                        params)
