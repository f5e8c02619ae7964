"""The arithmetic of the end-to-end metrics over a window's requests.

Every time is on the host clock, in seconds from the window's start: a
request of the ramp before it has negative times. A request is recorded
at the megastep boundaries the harness sees: when it was submitted, when
it left the queue, when the boundary whose readback held its first token
ended, and when the boundary that completed it ended.
"""

from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass
class Rec:
    client: int
    prompt_len: int
    max_new: int
    submit: float
    admit: float | None = None   # boundary at which it left WAITING
    first: float | None = None   # boundary whose readback held token 0
    done: float | None = None    # boundary that completed it
    tokens: int = 0              # tokens read back so far
    failed: bool = False         # the engine failed it
    req: object = None           # the engine's Request


def p95(values) -> float | None:
    """The 95th percentile by nearest rank (the smallest value with at
    least 95 % of the values at or below it); None for no values."""
    v = sorted(values)
    if not v:
        return None
    return float(v[max(0, math.ceil(0.95 * len(v)) - 1)])


def ttft_values(recs, t_end: float) -> list[float]:
    """Seconds from submit to first token, over every request submitted
    in the window [0, ``t_end``); one still without a first token counts
    its wait so far (``t_end`` - submit), so a stall at the end shows."""
    out = []
    for r in recs:
        if not 0.0 <= r.submit < t_end:
            continue
        first = r.first if r.first is not None and r.first <= t_end \
            else t_end
        out.append(first - r.submit)
    return out


def tpot_values(recs, t_end: float) -> list[float]:
    """Seconds a token after the first, over every request completed in
    the window [0, ``t_end``] with at least 2 tokens: (done - first) /
    (tokens - 1)."""
    return [(r.done - r.first) / (r.tokens - 1) for r in recs
            if r.done is not None and 0.0 <= r.done <= t_end
            and r.tokens >= 2]


def queue_waits(recs, t_end: float) -> list[float]:
    """Seconds from submit to admission, over the requests submitted in
    the window and admitted by ``t_end``."""
    return [r.admit - r.submit for r in recs
            if r.submit >= 0.0 and r.admit is not None
            and r.admit <= t_end]


def passes(prompt_len: int, consumed: int, n_gen: int) -> int:
    """Forward passes a request has run: one per prompt token consumed,
    then one per generated token fed back (the last token generated is
    never fed)."""
    if consumed < prompt_len:
        return consumed
    return prompt_len + max(0, n_gen - 1)
