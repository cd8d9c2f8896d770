"""Speculative decoding's host half: n-gram drafts and greedy acceptance
(``paddle_tpu/serving/speculative.py`` analog; host-only, no torch).

The device half is the engine's verify step: the decode step widened to a
static ``[B, k+1]`` token block (``GPTForCausalLM.extend_step``), captured
once as a CUDA graph (``serving/graphs.py``). This module proposes the
drafts and decides how many verified tokens to keep.

Drafts come from prompt lookup: find the most recent earlier occurrence of
the last ``ngram`` context tokens and propose what followed it. Greedy
acceptance keeps the output exact: draft token ``j`` is accepted iff it
equals the model's argmax at verify position ``j-1``, and the first
rejection is replaced by that argmax, so the emitted stream is the
one-at-a-time greedy stream. Rejected drafts cost nothing on the device:
their K/V lies at positions the next verify step rewrites before any
attend reads them.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence, Tuple


@dataclass(frozen=True)
class SpeculativeConfig:
    """``k``: draft tokens verified per step (the verify block is ``k+1``
    wide). ``ngram``: the longest context suffix the proposer tries to
    match (it backs off to shorter ones, then to repeating the last
    token)."""
    k: int = 3
    ngram: int = 3

    def __post_init__(self):
        if self.k < 1:
            raise ValueError(f"speculative k must be >= 1, got {self.k}")
        if self.ngram < 1:
            raise ValueError(f"ngram must be >= 1, got {self.ngram}")


def propose_ngram(context: Sequence[int], k: int, ngram: int) -> List[int]:
    """``k`` draft tokens for ``context`` by prompt lookup: the longest
    suffix (length <= ``ngram``) that recurs earlier in the context
    nominates its continuation; repeats of the last token pad it, or stand
    in when nothing matches. Always exactly ``k`` tokens."""
    ctx = [int(t) for t in context]
    n = len(ctx)
    for g in range(min(ngram, n - 1), 0, -1):
        suffix = ctx[n - g:]
        # the most recent earlier occurrence wins
        for i in range(n - g - 1, -1, -1):
            if ctx[i:i + g] == suffix:
                cont = ctx[i + g:i + g + k]
                if cont:
                    while len(cont) < k:
                        cont.append(cont[-1])
                    return cont
                break  # the suffix recurs only at the very end: shorter g
    return [ctx[-1]] * k if ctx else [0] * k


def accept_greedy(drafts: Sequence[int],
                  greedy_targets: Sequence[int]) -> Tuple[int, List[int]]:
    """``drafts``: the ``k`` proposed tokens; ``greedy_targets[j]``: the
    model's argmax at verify position ``j``. Returns ``(accepted,
    emitted)``: the accepted prefix plus the model's own token at the first
    divergence, 1 to ``k+1`` tokens, exactly what one-at-a-time greedy
    decode would have produced."""
    a = 0
    emitted: List[int] = []
    for j, d in enumerate(drafts):
        if int(d) != int(greedy_targets[j]):
            break
        emitted.append(int(d))
        a += 1
    emitted.append(int(greedy_targets[a]))
    return a, emitted
