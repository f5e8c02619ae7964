"""Host-offloaded AdamW: the optimizer's moments in the capacity tier
(port of ``repro/optim/host_offload.py``).

The paper's headline capacity case runs a 671B model out of CXL memory
(§6.4). Its training counterpart: the Adam moments (f32 m and v, 8 bytes
a parameter, the largest training state) live in host memory, the "CXL
pool", and stream through the full-duplex PCIe link every step:

    for each chunk: H2D(m, v chunk k+1)  ||  D2H(updated m, v chunk k)

``DuplexOffloadEngine.plan_state_stream`` plans that stream (a 50/50
read/write mix by construction, the paper's best case); the report's
``duplex_us`` / ``serial_us`` / ``duplex_speedup`` are that modelled
plan and equal the reference's exactly for the same parameter shapes.

The moments are CPU f32 tensors. With the parameters on the card they
are pinned (page-locked), so each copy is one DMA at the link's rate
rather than a staged copy through a pageable bounce buffer; on the CPU
they are plain. The update walks the leaves in the reference's order
(sorted keys), one at a time: the leaf's moments are copied to the
parameters' device, updated there, and copied back into the host tensors
in place. Each copy completes before the next leaf starts (the
reference's serial structure; overlapping them is later work). The port
also records the measured wall time of that whole streamed loop per step
(``measured_us``: every page-in, update and writeback, the last
writeback landed in host memory) beside the modelled times.
"""

from __future__ import annotations

import dataclasses
import time

import torch

from repro_torch.core import channel as channel_lib
from repro_torch.core.offload import DuplexOffloadEngine
from repro_torch.models.layers import tree_leaves, tree_map, tree_unflatten
from repro_torch.optim.adamw import (AdamWConfig, bias_corrections,
                                     clip_by_global_norm)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@dataclasses.dataclass
class HostOffloadAdamW:
    """AdamW with m/v resident in the host pool, streamed per step."""

    cfg: AdamWConfig
    chunk_bytes: float = 64 * 2 ** 20     # 64 MB streaming granularity
    engine: DuplexOffloadEngine = dataclasses.field(
        default_factory=lambda: DuplexOffloadEngine(
            link=channel_lib.PCIE_HOST))

    def init(self, params) -> dict:
        device = next(tree_leaves(params)).device
        pin = device.type == "cuda"

        def host_zeros(p):
            z = torch.zeros(p.shape, dtype=torch.float32)
            return z.pin_memory() if pin else z

        self._m = tree_map(host_zeros, params)
        self._v = tree_map(host_zeros, params)
        self.last_transfer_report: dict = {}
        return {"step": torch.zeros((), dtype=torch.int32, device=device)}

    def state_bytes(self) -> float:
        return sum(x.numel() * x.element_size()
                   for x in tree_leaves(self._m)) * 2.0

    @staticmethod
    def _leaf_update(p, g, m, v, lr, bc1, bc2, b1, b2, eps, wd):
        """The reference's jitted per-leaf update, whose scalars are f32
        arguments (so ``1 - b1`` is taken in f32 here, in a Python double
        in ``adamw_update``)."""
        gf = g.to(torch.float32)
        m2 = b1 * m + (1.0 - b1) * gf
        v2 = b2 * v + (1.0 - b2) * torch.square(gf)
        upd = (m2 / bc1) / (torch.sqrt(v2 / bc2) + eps)
        pf = p.to(torch.float32)
        return (pf - lr * (upd + wd * pf)).to(p.dtype), m2, v2

    @torch.no_grad()
    def update(self, params, grads, state):
        """Streamed update: moments page in/out leaf by leaf."""
        cfg = self.cfg
        grads, gnorm = clip_by_global_norm(grads, cfg.clip_norm)
        step = state["step"] + 1
        lr, bc1, bc2 = bias_corrections(cfg, step)
        scalars = [torch.full((), x, dtype=torch.float32, device=step.device)
                   for x in (cfg.b1, cfg.b2, cfg.eps, cfg.weight_decay)]

        new_p = []
        moved = 0.0
        _sync(step.device)
        t0 = time.perf_counter()
        for p, g, m, v in zip(tree_leaves(params), tree_leaves(grads),
                              tree_leaves(self._m), tree_leaves(self._v)):
            # H2D page-in of this leaf's moments
            m_dev = m.to(p.device)
            v_dev = v.to(p.device)
            p2, m2, v2 = self._leaf_update(p, g, m_dev, v_dev, lr, bc1, bc2,
                                           *scalars)
            # D2H writeback of the updated moments, in place in the host
            # pool (waits for the update: the reference's np.asarray)
            m.copy_(m2)
            v.copy_(v2)
            new_p.append(p2)
            moved += (m.numel() * m.element_size()
                      + v.numel() * v.element_size())
        _sync(step.device)
        measured_us = (time.perf_counter() - t0) * 1e6

        # modelled duplex link occupancy for this step's moment traffic
        # (chunk adapts down so even small states pipeline >= 16 deep)
        chunk = min(self.chunk_bytes, max(moved / 16.0, 1 << 16))
        duplex, serial = self.engine.plan_state_stream(
            nbytes=moved, chunk_bytes=chunk)
        self.last_transfer_report = {
            "moment_bytes": moved,
            "duplex_us": duplex.modelled_time_us(),
            "serial_us": serial.modelled_time_us(),
            "duplex_speedup": self.engine.speedup(duplex, serial),
            "measured_us": measured_us,
        }
        return (tree_unflatten(params, new_p), {"step": step},
                {"lr": lr, "grad_norm": gnorm})
