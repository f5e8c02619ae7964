"""The closed-loop traffic generator: one general generator over the
parameters of a ``traffic/<name>.json`` file.

C clients each send a request, wait for it to complete, and send the
next at once (no think time), so the engine sees C requests at all
times. Client c's k-th request:

* sizes: fixed by the traffic file alone, the same for every seed. In
  round k the clients' prompt lengths are a permutation of C stratified
  quantiles of the prompt distribution, their output lengths an
  independent permutation of C quantiles of the output distribution
  (round 0 of ``first_output``, so that the first completions spread out
  from the start). Which client gets which size steers the engine's
  admission, and with it the work a window holds: were the seed to deal
  them, runs of one cell would differ by the deal and not by the
  program;
* tokens: the prompt's ids, from the seed, uniform over the vocabulary.

A distribution is ``{"dist": "loguniform" | "uniform", "min", "max"}``.
A traffic file also names where its lengths come from: ``source`` (a
public trace or paper), ``figures`` (the numbers taken from it),
``assumed`` (what the source does not fix), ``reduced`` (each figure cut,
with the reason) and ``deployment`` (what the clients stand for). The
generator reads none of them.
"""

from __future__ import annotations

import math

import numpy as np


def quantiles(dist: dict, n: int) -> np.ndarray:
    """``n`` stratified quantiles (i + 0.5) / n of ``dist``, rounded to
    whole tokens, ascending."""
    lo, hi = float(dist["min"]), float(dist["max"])
    u = (np.arange(n) + 0.5) / n
    if dist["dist"] == "loguniform":
        x = np.exp(math.log(lo) + u * (math.log(hi) - math.log(lo)))
    elif dist["dist"] == "uniform":
        x = lo + u * (hi - lo)
    else:
        raise ValueError(f"unknown distribution {dist['dist']!r}")
    return np.clip(np.rint(x), lo, hi).astype(np.int64)


#: the schedule of sizes is the same for every seed
SCHEDULE_SEED = 0


def _rng(seed: int, *tags: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) % (1 << 64), *tags])


class ClosedLoop:
    """The requests of a closed loop of ``traffic['clients']`` clients
    over a vocabulary of ``vocab`` ids, from ``seed``."""

    def __init__(self, traffic: dict, vocab: int, seed: int):
        if traffic.get("loop") != "closed":
            raise ValueError(f"not a closed loop: {traffic.get('loop')!r}")
        self.clients = int(traffic["clients"])
        self.vocab = int(vocab)
        self.seed = int(seed)
        self._prompt_q = quantiles(traffic["prompt"], self.clients)
        self._output_q = quantiles(traffic["output"], self.clients)
        self._first_q = quantiles(traffic.get("first_output",
                                              traffic["output"]),
                                  self.clients)
        self._rounds: dict[int, tuple[np.ndarray, np.ndarray]] = {}
        self.max_total = int(traffic["prompt"]["max"]) + max(
            int(traffic["output"]["max"]),
            int(traffic.get("first_output", traffic["output"])["max"]))

    def sizes(self, k: int) -> tuple[np.ndarray, np.ndarray]:
        """Round k's (prompt lengths, output lengths), one per client."""
        if k not in self._rounds:
            rng = _rng(SCHEDULE_SEED, 1, k)
            outs = self._first_q if k == 0 else self._output_q
            self._rounds[k] = (rng.permutation(self._prompt_q),
                               rng.permutation(outs))
        return self._rounds[k]

    def request(self, client: int, k: int) -> tuple[np.ndarray, int]:
        """Client ``client``'s k-th request: (prompt ids int32, new
        tokens)."""
        plen, outs = self.sizes(k)
        rng = _rng(self.seed, 2, k, client)
        prompt = rng.integers(0, self.vocab, size=int(plen[client]),
                              dtype=np.int64).astype(np.int32)
        return prompt, int(outs[client])
