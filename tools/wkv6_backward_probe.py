"""Where the wkv6 backward kernel's time goes, on one CUDA card.

Times the tree's ``wkv6_backward`` kernel (``src/repro_torch/kernels/
csrc/rwkv6_scan.cu``) against an earlier version of it in turns (new,
old, old, new) at the rwkv6-7b training shape (B, S, H, hs) = (2, 4096,
64, 64), beside the forward ``wkv6`` kernel in the same process, and
splits each kernel's time into its phases: an instrumented copy of each
source records ``clock64`` per phase of thread 0 (and of the block's last
thread) into a buffer set through a ``__device__`` pointer. Two further
copies are timed and give wrong gradients on purpose: the earlier
kernel with its per-block state scratch (``hist``) neither stored nor
read (a runtime flag of its instrumented copy), and the tree's kernel
with its row sums' shuffles left out (``no_row_sums_ms``).

The earlier version is the kernel at commit ``c5a9fbd`` (one launch,
``hist`` in global memory, 13 pointers in its C interface); take it
from git:

    mkdir -p build/probe
    git show c5a9fbd:src/repro_torch/kernels/csrc/rwkv6_scan.cu \\
        > build/probe/hist_kernel.cu
    python tools/wkv6_backward_probe.py --old build/probe/hist_kernel.cu

Every copy is written and built under ``build/probe/``. Prints one JSON
object. Needs a CUDA card and nvcc; imports PyTorch, not JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src")]

import torch  # noqa: E402

from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import rwkv6_scan as rs  # noqa: E402

OUT = ROOT / "build" / "probe"
SHAPE = (2, 4096, 64, 64)


def _edit(src: str, edits) -> str:
    for a, b in edits:
        if src.count(a) != 1:
            raise ValueError(f"the source has {src.count(a)} of {a[:60]!r}")
        src = src.replace(a, b)
    return src


_PROBE_SETTER = (
    'extern "C" const char* rwkv6_scan_error_string',
    'extern "C" int wkv6_bwd_set_probe(void* buf, int flag) {\n'
    '  cudaError_t e = cudaMemcpyToSymbol(g_clk, &buf, sizeof(void*));\n'
    '  if (e != cudaSuccess) return static_cast<int>(e);\n'
    '  return static_cast<int>(cudaMemcpyToSymbol(g_flag, &flag, '
    'sizeof(int)));\n}\n\nextern "C" const char* rwkv6_scan_error_string')
_GLOBALS = (
    "namespace {\n\ntemplate <int HS>\nstruct BwdShape {",
    "__device__ long long* g_clk = nullptr;\n__device__ int g_flag = 0;\n"
    "#define CK(i) { long long c_ = clock64(); ck[i] += c_ - cm; cm = c_; }"
    "\n\nnamespace {\n\ntemplate <int HS>\nstruct BwdShape {")
_WRITE = (
    "    du_part[static_cast<long long>(bh) * HS + tid] = acc;\n  }\n}",
    "    du_part[static_cast<long long>(bh) * HS + tid] = acc;\n  }\n"
    "  if (g_clk != nullptr && (tid == 0 || tid == C::kThreads - 1)) {\n"
    "    long long* o = g_clk + (bh * 2 + (tid != 0)) * 12;\n"
    "    for (int i = 0; i < 11; ++i) o[i] = ck[i];\n"
    "    o[11] = clock64() - c_start;\n  }\n}")
_CLOCKS = "  long long ck[12] = {0};\n  long long cm = clock64();\n" \
          "  const long long c_start = cm;\n"

# the earlier kernel: pass 1, pass 2's staging, the recompute into hist, the
# walk back, the chunk's store; g_flag = 1 makes hist a no-op
OLD_PHASES = ["pass1", "stage", "recompute", "walkback", "store"]
OLD_EDITS = [
    _GLOBALS, _PROBE_SETTER, _WRITE,
    ("  // ---- pass 1: forward in time ----",
     "  const bool nohist = g_flag != 0;\n" + _CLOCKS
     + "  // ---- pass 1: forward in time ----"),
    ("  // ---- pass 2: backward in time, carrying G ----",
     "  CK(0);\n  // ---- pass 2: backward in time, carrying G ----"),
    ("    __syncthreads();\n    stage(t0);\n    // the chunk's states",
     "    cm = clock64();\n    __syncthreads();\n    stage(t0);\n"
     "    // the chunk's states"),
    ("    __syncthreads();\n    for (int t = 0; t < n; ++t) {\n"
     "      float* hs_t",
     "    __syncthreads();\n    CK(1);\n    for (int t = 0; t < n; ++t) {\n"
     "      float* hs_t"),
    ("          hs_t[(m * NC + c) * C::kThreads + tid] = st[m][c];",
     "          if (!nohist) hs_t[(m * NC + c) * C::kThreads + tid] = "
     "st[m][c];"),
    ("    for (int t = n - 1; t >= 0; --t) {",
     "    CK(2);\n    for (int t = n - 1; t >= 0; --t) {"),
    ("          const float sp = hs_t[(m * NC + c) * C::kThreads + tid];",
     "          const float sp = nohist ? st[m][c] : "
     "hs_t[(m * NC + c) * C::kThreads + tid];"),
    ("      for (int c = 0; c < NC; ++c) sp_out[c] = dvp[c];\n    }\n"
     "    __syncthreads();",
     "      for (int c = 0; c < NC; ++c) sp_out[c] = dvp[c];\n    }\n"
     "    CK(3);\n    __syncthreads();"),
    ("        du4.w = fmaf(rr.w * kk.w, vd, du4.w);\n      }\n    }\n  }",
     "        du4.w = fmaf(rr.w * kk.w, vd, du4.w);\n      }\n    }\n"
     "    CK(4);\n  }"),
]

# the tree's kernel: an item's wait for its copies, the barrier, the
# copies of the item kAhead later, pass 1's walks, the segments' forward
# walks, the recompute into registers, the walk back, the sub-chunk's
# barrier and store
NEW_PHASES = ["wait", "barrier", "copies", "pass1", "forward", "recompute",
              "walkback", "store", "other", "store_barrier"]
NEW_EDITS = [
    _GLOBALS, _PROBE_SETTER, _WRITE,
    ("  const int share = lane % kShare;\n",
     "  const int share = lane % kShare;\n" + _CLOCKS),
    ("    cp_async_wait<C::kAhead - 1>();\n    __syncthreads();\n"
     "    issue(item + C::kAhead);",
     "    CK(8);\n    cp_async_wait<C::kAhead - 1>();\n    CK(0);\n"
     "    __syncthreads();\n    CK(1);\n    issue(item + C::kAhead);\n"
     "    CK(2);"),
    ("        walk(stg, st);\n      }\n      store_state(slot4(0), st);",
     "        walk(stg, st);\n        CK(3);\n      }\n"
     "      store_state(slot4(0), st);"),
    ("        store_state(slot4((sb + 1) % kSlots), st);\n",
     "        store_state(slot4((sb + 1) % kSlots), st);\n        CK(4);\n"),
    ("          store_state(slot4((sb + j + 1) % kSlots), st);\n",
     "          store_state(slot4((sb + j + 1) % kSlots), st);\n"
     "          CK(4);\n"),
    ("        // the walk back (steps past S",
     "        CK(5);\n        // the walk back (steps past S"),
    ("        __syncthreads();\n        // the sub-chunk's gradients",
     "        CK(6);\n        __syncthreads();\n        CK(9);\n"
     "        // the sub-chunk's gradients"),
    ("      }\n    }\n  }\n  cp_async_wait<0>();",
     "        CK(7);\n      }\n    }\n  }\n  cp_async_wait<0>();"),
]
# timing only: the walk back's row sums left unsummed across lanes
NO_ROW_SUMS = [("RowSum<kSums, C::kColGroups / 2>::run(x, lane)", "0")]


def _lib(path: Path, pointers: int, probe: bool) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(_build.library_path(path)))
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    lib.wkv6_backward_launch.argtypes = [vp] * pointers + [i32] * 4 + [vp]
    lib.wkv6_launch.argtypes = [vp] * 6 + [i32] * 4 + [vp]
    if probe:
        lib.wkv6_bwd_set_probe.argtypes = [vp, i32]
    return lib


def _median_ms(fn, iters: int = 5) -> float:
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(iters):
        a, b = torch.cuda.Event(True), torch.cuda.Event(True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        out.append(a.elapsed_time(b))
    return sorted(out)[len(out) // 2]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--old", required=True, type=Path,
                    help="the earlier rwkv6_scan.cu (its backward with hist)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    OUT.mkdir(parents=True, exist_ok=True)
    new_src = rs.SOURCE.read_text()
    old_src = args.old.read_text()
    files = {
        "new": rs.SOURCE,
        "old": args.old.resolve(),
        "new_probe": (OUT / "new_probe.cu", _edit(new_src, NEW_EDITS)),
        "old_probe": (OUT / "old_probe.cu", _edit(old_src, OLD_EDITS)),
        "new_no_row_sums": (OUT / "new_no_row_sums.cu",
                            _edit(new_src, NO_ROW_SUMS)),
    }
    paths = {}
    for key, f in files.items():
        if isinstance(f, tuple):
            f[0].write_text(f[1])
            f = f[0]
        paths[key] = f
    with ThreadPoolExecutor(len(paths)) as pool:
        list(pool.map(_build.build, paths.values()))
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    libs = {k: _lib(p, 13 if k.startswith("old") else 12, "probe" in k)
            for k, p in paths.items()}

    B, S, H, hs = SHAPE
    g = torch.Generator().manual_seed(98)
    r, k, v, n, d = (torch.randn(SHAPE, generator=g) for _ in range(5))
    w = torch.exp(-torch.exp(-1.0 + n))
    u = 0.5 * torch.randn((H, hs), generator=g)
    x = [t.cuda().contiguous() for t in (r, k, v, w, u, d)]
    grads = [torch.empty_like(x[0]) for _ in range(4)]
    du_part = torch.empty((B, H, hs), device="cuda")
    kept = rs._backward_scratch(B, S, H, hs, "cuda")
    old_ckpt = torch.empty(B * H * (S // 16) * hs * hs, device="cuda")
    hist = torch.empty(B * H * 16 * hs * hs, device="cuda")
    stream = lambda: ctypes.c_void_p(
        torch.cuda.current_stream().cuda_stream)

    def call(key):
        lib = libs[key]
        scratch = (old_ckpt.data_ptr(), hist.data_ptr()) \
            if key.startswith("old") else (kept.data_ptr(),)
        rc = lib.wkv6_backward_launch(
            *(t.data_ptr() for t in x), *(t.data_ptr() for t in grads),
            du_part.data_ptr(), *scratch, B, S, H, hs, stream())
        if rc != 0:
            raise RuntimeError(f"{key}: launch failed ({rc})")

    res = {"card": card.strip(), "shape": list(SHAPE)}
    # the card raises its clock under load: ~2 s of calls before timing
    for _ in range(100):
        call("new")
        call("old")
    call("new")
    same = [t.clone() for t in grads]
    call("old")
    res["old_equals_new"] = [bool(torch.equal(a, b))
                             for a, b in zip(grads, same)]
    res["order"] = "new old old new"
    res["times_ms"] = [_median_ms(lambda: call(key))
                       for key in ("new", "old", "old", "new")]
    res["no_row_sums_ms"] = _median_ms(lambda: call("new_no_row_sums"))
    out = torch.empty_like(x[0])
    res["forward_ms"] = _median_ms(lambda: libs["new"].wkv6_launch(
        *(t.data_ptr() for t in x[:5]), out.data_ptr(), B, S, H, hs,
        stream()), iters=10)
    new_ms = (res["times_ms"][0] + res["times_ms"][3]) / 2
    old_ms = (res["times_ms"][1] + res["times_ms"][2]) / 2
    res["new_over_old"] = new_ms / old_ms
    res["new_over_forward"] = new_ms / res["forward_ms"]
    res["old_over_forward"] = old_ms / res["forward_ms"]

    clk = torch.zeros(B * H * 2 * 12, dtype=torch.int64, device="cuda")
    for key, names, flag in (("old_probe", OLD_PHASES, 0),
                             ("old_probe", OLD_PHASES, 1),
                             ("new_probe", NEW_PHASES, 0)):
        lib = libs[key]
        lib.wkv6_bwd_set_probe(ctypes.c_void_p(clk.data_ptr()), flag)
        ms = _median_ms(lambda: call(key))
        lib.wkv6_bwd_set_probe(ctypes.c_void_p(0), 0)
        c = clk.view(B * H, 2, 12).double()
        per_step = c.mean(0) / S
        name = key + ("_no_hist" if flag else "")
        res[name] = {
            "ms": ms, "mhz": c[:, 0, 11].max().item() / ms / 1e3,
            "cycles_a_step_thread0": dict(zip(
                names + ["total"], per_step[0, :len(names)].tolist()
                + [per_step[0, 11].item()])),
            "cycles_a_step_last_thread": dict(zip(
                names + ["total"], per_step[1, :len(names)].tolist()
                + [per_step[1, 11].item()]))}
    print(json.dumps(res, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
