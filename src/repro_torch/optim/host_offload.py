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
(sorted keys), one at a time, and each leaf in ``adamw.CHUNK``-element
chunks (64 MB of each moment, the plan's default granularity): the
chunk's moments are copied to the parameters' device, updated there in
place (``adamw.update_chunk``), and copied back into the host tensors in
place. The update is elementwise, so the chunks change no
value; they bound the optimizer's transient on the device to a few
chunks, where whole leaves would take about ten f32 copies of the
largest leaf (an expert stack of mixtral-8x7b at 4 layers is 7.5 GB in
f32). Each copy completes before the next chunk starts (the reference's
serial structure; overlapping them is later work). The port
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
from repro_torch.optim.adamw import (AdamWConfig, bias_corrections, chunks,
                                     clip_by_global_norm, update_chunk)


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
            return torch.zeros(p.shape, dtype=torch.float32, pin_memory=pin)

        self._m = tree_map(host_zeros, params)
        self._v = tree_map(host_zeros, params)
        self.last_transfer_report: dict = {}
        return {"step": torch.zeros((), dtype=torch.int32, device=device)}

    def state_bytes(self) -> float:
        return sum(x.numel() * x.element_size()
                   for x in tree_leaves(self._m)) * 2.0

    @torch.no_grad()
    def update(self, params, grads, state):
        """Streamed update: moments page in/out leaf by leaf, chunk by
        chunk."""
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
            new = torch.empty_like(p, memory_format=torch.contiguous_format)
            flat_p, flat_g, flat_new = (t.reshape(-1) for t in (p, g, new))
            flat_m, flat_v = m.view(-1), v.view(-1)
            for c in chunks(flat_p.numel()):
                # H2D page-in of this chunk's moments
                m_dev = flat_m[c].to(p.device)
                v_dev = flat_v[c].to(p.device)
                # the reference's jitted per-leaf update, whose scalars
                # are f32 arguments (so 1 - b1 is taken in f32 here)
                update_chunk(flat_p[c], flat_g[c], m_dev, v_dev, lr, bc1,
                             bc2, *scalars, out=(flat_new[c], m_dev, v_dev))
                # D2H writeback of the updated moments, in place in the
                # host pool (waits for the update: the reference's
                # np.asarray)
                flat_m[c].copy_(m_dev)
                flat_v[c].copy_(v_dev)
            new_p.append(new.view(p.shape))
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
