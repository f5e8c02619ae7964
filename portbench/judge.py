"""Whether what the timed path produced is correct.

Served tokens: once the window has closed, a sample of the finished
requests, drawn from the seed with the one that served the most tokens
in it, goes through the plain reference once, prompt and served tokens
together (teacher forcing). At each served token the reference's best
logit minus its logit of the served token is that token's gap: 0 where
the program picked the reference's choice, small where it picked one of
a near tie, large where it served a wrong token. The number compared is
the widest gap over the sample. This is valid for greedy tokens, which
is all the engine serves.

The control reads, at the same positions of the same sequences, the gap
of the token that the reference computed in fp8 puts first.

Paged blocks: for a sample of the requests still live at the end, every
block the pool holds for them, read from HBM where it is resident and
dequantized from the int8 host tier where it is not, against the
reference's keys and values of those positions. The number compared is
the widest relative error ||block - reference|| / ||reference|| of a
block.
"""

from __future__ import annotations

import numpy as np
import torch


#: served tokens each run judges at least: some hundreds, with the
#: longest request finished
JUDGE_TOKENS = 512


def _rng(seed: int, tag: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) % (1 << 64), tag])


def sample_finished(recs, seed: int, tokens: int) -> list:
    """The finished request with the most served tokens, then others in
    an order drawn from ``seed``, until ``tokens`` served tokens."""
    done = [r for r in recs if r.done is not None and r.tokens > 0]
    if not done:
        return []
    done.sort(key=lambda r: (r.submit, r.client))
    longest = max(done, key=lambda r: r.tokens)
    rest = [r for r in done if r is not longest]
    order = _rng(seed, 3).permutation(len(rest))
    out, n = [longest], longest.tokens
    for i in order:
        if n >= tokens:
            break
        out.append(rest[i])
        n += rest[i].tokens
    return out


def served_sequences(recs) -> list[tuple[np.ndarray, int]]:
    """Per request: its prompt and served tokens but the last (every
    token the model was fed, or would have been), and the position whose
    logits chose the first served token."""
    seqs = []
    for r in recs:
        gen = np.asarray(r.req.generated, np.int64)
        toks = np.concatenate([np.asarray(r.req.prompt, np.int64),
                               gen[:-1]])
        seqs.append((toks, r.prompt_len - 1))
    return seqs


def gaps(ref_logits, picked) -> torch.Tensor:
    """Per position: the best logit minus the logit of the picked
    token."""
    best = ref_logits.max(dim=-1).values
    return best - ref_logits.gather(-1, picked[:, None].long())[:, 0]


def served_gaps(ref_out, recs) -> torch.Tensor:
    """The gaps of every served token of ``recs``."""
    return torch.cat([
        gaps(out["logits"], torch.as_tensor(
            np.asarray(r.req.generated, np.int64),
            device=out["logits"].device))
        for out, r in zip(ref_out, recs)])


def control_gaps(ref_out, ctrl_out) -> torch.Tensor:
    """The gaps of the tokens the control puts first."""
    return torch.cat([gaps(a["logits"], b["logits"].argmax(dim=-1))
                      for a, b in zip(ref_out, ctrl_out)])


def gap_stats(g: torch.Tensor) -> dict:
    """The widest gap, the mean, the 99th percentile (nearest rank) and
    the share of tokens not the reference's best."""
    v = torch.sort(g.float()).values
    return {"widest": float(v[-1]), "mean": float(v.mean()),
            "p99": float(v[max(0, -(-99 * v.numel() // 100) - 1)]),
            "mismatch": float((v > 0).float().mean())}


def sample_live(recs, seed: int, n: int) -> list:
    """``n`` of the live requests that hold pool blocks, drawn from
    ``seed``."""
    live = [r for r in recs if r.done is None and not r.failed
            and r.req is not None and r.req.blocks]
    live.sort(key=lambda r: (r.submit, r.client))
    order = _rng(seed, 4).permutation(len(live))
    return [live[i] for i in order[:n]]


def pool_blocks(pool, rec) -> torch.Tensor:
    """The blocks the pool holds for ``rec``'s request, in order, as f32
    (n, block_tokens, kv_dims): the HBM copy where it is resident, else
    the host tier's int8 rows times their scales; zeros for a block that
    is in neither (its data is lost, and reads an error of 1)."""
    rows = []
    for b in rec.req.blocks:
        s = int(pool.slot_of[b])
        h = int(pool.host.slot_of[b])
        if s >= 0:
            rows.append(pool.hbm[s].float())
        elif h >= 0:
            rows.append(pool.host_q[h].float() * pool.host_scale[h])
        else:
            rows.append(torch.zeros(pool.block_shape, dtype=torch.float32,
                                    device=pool.hbm.device))
    return torch.stack(rows)


def fed_tokens(rec, n_tokens: int) -> np.ndarray:
    """The first ``n_tokens`` tokens ``rec``'s request was fed."""
    toks = np.concatenate([np.asarray(rec.req.prompt, np.int64),
                           np.asarray(rec.req.generated, np.int64)])
    if toks.size < n_tokens:
        raise RuntimeError(f"request holds {n_tokens} tokens of blocks but "
                           f"was fed {toks.size}")
    return toks[:n_tokens]


def kv_rel_err(ref_kv, blocks) -> float:
    """The widest ||block - ref|| / ||ref|| over the blocks; ref_kv
    (S, L, 2, KV, hd), blocks (n, bt, kv_dims) with n * bt == S."""
    n, bt, kvd = blocks.shape
    ref = ref_kv.reshape(n, bt, kvd)
    err = torch.linalg.vector_norm((blocks - ref).reshape(n, -1), dim=1)
    norm = torch.linalg.vector_norm(ref.reshape(n, -1), dim=1)
    return float((err / norm).max())
