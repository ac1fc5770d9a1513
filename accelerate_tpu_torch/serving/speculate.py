"""Speculative multi-token decode: draft providers and the acceptance
arithmetic (mirrors ``accelerate_tpu/serving/speculate.py``: ``NgramDraft``
:46, ``DraftModelDraft`` :133, ``make_draft_provider`` :184,
``Speculator`` :199, ``predicted_acceptance`` :239,
``speculative_page_need`` :290).

Plain decode emits one token per slot and pass.  Speculative decode
proposes ``k`` candidate tokens per slot and runs ONE batched verify pass
of width ``bucket + 1`` through the paged cache, accepting the longest
greedy-matching prefix; the accepted tokens are the ones sequential greedy
decode emits.  On the card the verify pass's attention is kernel #6 / #7
(``paged_multitoken_attention``) where plain decode takes #4 / #5.

Two draft providers:

- :class:`NgramDraft` — prompt-lookup self-drafting: host-side, no model.
  The slot's context is searched for the most recent earlier occurrence of
  its trailing n-gram, and the tokens that followed it are the proposal.
- :class:`DraftModelDraft` — a small model proposes ``k`` tokens greedily
  from a fixed context window through one cache-free forward per token
  (no draft KV cache to keep in step with evictions and rollbacks); on
  the card its attention is the flash forward, kernel #1, at T = window.

Rejected drafts cost only their verify lane: the verify step pushes the
pages it took past the accepted frontier back onto the free stack, and
the scheduler's host mirror follows the accepted lengths
(``scheduler.note_verify``).

:func:`predicted_acceptance` is the predicted twin: a model-free replay of
the draft-and-verify arithmetic over the measured token streams.
"""

from __future__ import annotations

import time
from typing import Sequence

import numpy as np
import torch


class NgramDraft:
    """Prompt-lookup self-drafting (host-side, no extra model).

    For each slot, the trailing ``n``-gram of the context (``max_ngram``
    down to ``min_ngram``) is searched for its most recent earlier
    occurrence; the up-to-``k`` tokens that followed that occurrence are the
    proposal.  Deterministic: same context -> same drafts, always (the
    scheduler-determinism contract extends through drafting).  ``window``
    bounds the backward search so drafting stays O(window) per slot on
    arbitrarily long contexts.
    """

    name = "ngram"
    programs = 0  # host-side: no compiled draft program

    def __init__(self, max_ngram: int = 3, min_ngram: int = 1,
                 window: int = 512):
        if not 1 <= min_ngram <= max_ngram:
            raise ValueError(
                f"need 1 <= min_ngram <= max_ngram, got "
                f"({min_ngram}, {max_ngram})"
            )
        self.max_ngram = max_ngram
        self.min_ngram = min_ngram
        self.window = window

    def propose_one(self, context: Sequence[int], k: int) -> list:
        ctx = list(context)[-self.window:]
        n_ctx = len(ctx)
        for n in range(min(self.max_ngram, n_ctx - 1), self.min_ngram - 1, -1):
            tail = ctx[n_ctx - n:]
            best: list = []
            # most recent match with a FULL k-token continuation wins;
            # otherwise the longest continuation seen (a trailing cycle's
            # matches near the end are cut short by the context boundary)
            for i in range(n_ctx - n - 1, -1, -1):
                if ctx[i:i + n] == tail:
                    cont = ctx[i + n:i + n + k]
                    if len(cont) == k:
                        return cont
                    if len(cont) > len(best):
                        best = cont
            if best:
                return best
        return []

    def propose(self, contexts: list, k: int,
                adapter_ids=None) -> tuple[np.ndarray, np.ndarray]:
        """Batched proposal: ``(drafts [n, k] int32, draft_lens [n])``.
        Slots with no n-gram hit draft nothing (their verify lane
        degenerates to plain single-token decode).  ``adapter_ids`` is
        accepted for interface parity with the draft-model provider — an
        n-gram over the slot's own context is already tenant-specific."""
        n = len(contexts)
        drafts = np.zeros((n, k), np.int32)
        lens = np.zeros((n,), np.int32)
        for i, ctx in enumerate(contexts):
            prop = self.propose_one(ctx, k)
            lens[i] = len(prop)
            drafts[i, :len(prop)] = prop
        return drafts, lens

    def warmup(self, n_slots: int, k: int) -> None:
        """Host-side provider: nothing to compile."""


class DraftModelDraft:
    """Draft-model provider: a small model proposes ``k`` greedy tokens.

    Stateless by design: each draft token re-forwards every slot's
    trailing ``window`` tokens (right-padded ``[n, window]`` ids, positions
    ``0..window-1``) through the model's cache-free forward, and reads the
    logits at each slot's last real token.  The window slides when full, so
    contexts of any length draft at one shape.  ``model`` is a
    :class:`~accelerate_tpu_torch.models.llama.LlamaForCausalLM` (its own
    weights, on the serving device); its ``attn_implementation`` picks the
    attention: ``"flash"`` runs kernel #1 on the card.
    """

    name = "draft"
    programs = 1  # the windowed next-token forward

    def __init__(self, model, window: int = 32):
        if window < 2:
            raise ValueError(f"draft window must be >= 2, got {window}")
        self.model = model
        self.window = window

    @torch.inference_mode()
    def _next(self, ids: np.ndarray, lens: np.ndarray) -> np.ndarray:
        """The greedy next token of each row: argmax over f32 logits at
        the row's last real token (one host sync)."""
        dev = self.model.device
        n, w = ids.shape
        positions = torch.arange(w, device=dev).expand(n, w)
        logits = self.model(torch.from_numpy(ids).to(dev), positions=positions)
        rows = torch.arange(n, device=dev)
        last = logits[rows, torch.from_numpy(lens - 1).to(dev).long()]
        return last.float().argmax(dim=-1).to(torch.int32).cpu().numpy()

    def propose(self, contexts: list, k: int,
                adapter_ids=None) -> tuple[np.ndarray, np.ndarray]:
        n = len(contexts)
        w = self.window
        ids = np.zeros((n, w), np.int32)
        lens = np.zeros((n,), np.int32)
        for i, ctx in enumerate(contexts):
            tail = list(ctx)[-w:]
            ids[i, :len(tail)] = tail
            lens[i] = max(1, len(tail))
        drafts = np.zeros((n, k), np.int32)
        for j in range(k):
            tok = self._next(ids, lens)
            drafts[:, j] = tok
            # slide: append the drafted token, dropping the oldest when full
            full = lens >= w
            ids[full] = np.roll(ids[full], -1, axis=1)
            ids[np.arange(n), np.where(full, w - 1, lens)] = tok
            lens = np.minimum(lens + 1, w)
        return drafts, np.full((n,), k, np.int32)

    def warmup(self, n_slots: int, k: int) -> None:
        """Run the draft forward once before traffic (builds kernel #1 on
        the card)."""
        self.propose([[1]] * max(1, n_slots), max(1, k))


def make_draft_provider(mode: str, *, draft_model=None, window: int = 32,
                        max_ngram: int = 3):
    """Resolve a ``ServingPlugin.speculate`` mode to a provider instance."""
    if mode == "ngram":
        return NgramDraft(max_ngram=max_ngram)
    if mode == "draft":
        if draft_model is None:
            raise ValueError(
                "speculate='draft' needs draft_model "
                "(pass it to ServingEngine / generate_paged)"
            )
        return DraftModelDraft(draft_model, window=window)
    raise ValueError(f"unknown speculate mode {mode!r} (ngram | draft)")


class Speculator:
    """Host-side drafting state for one engine: the provider, the depth
    ``k``, the verify bucket ladder, and the draft-time accounting the
    ``draft_overhead_frac`` bench field reads."""

    def __init__(self, provider, k: int, buckets: tuple):
        if k < 1:
            raise ValueError(f"speculate_k must be >= 1, got {k}")
        self.provider = provider
        self.k = k
        self.buckets = tuple(sorted(buckets))
        if not self.buckets or self.buckets[-1] < k:
            raise ValueError(
                f"speculate_buckets {buckets} must include a bucket >= k={k}"
            )
        self.draft_time_s = 0.0

    def bucket_for(self, depth: int) -> int:
        for b in self.buckets:
            if b >= depth:
                return b
        return self.buckets[-1]

    def draft(self, contexts: list, remaining: list,
              adapter_ids=None) -> tuple[np.ndarray, np.ndarray]:
        """Propose drafts for the active slots and clamp per-slot depth:
        ``spec_len[i] = min(draft_len, k, remaining-1)`` — a slot one token
        from ``max_new_tokens`` verifies at depth 0 (plain decode in lane
        0), so speculation can never overrun a request's token budget (or,
        transitively, its submit-guarded page capacity)."""
        t0 = time.perf_counter()
        drafts, lens = self.provider.propose(contexts, self.k, adapter_ids)
        self.draft_time_s += time.perf_counter() - t0
        spec_len = np.minimum(
            lens.astype(np.int64),
            np.maximum(np.asarray(remaining, np.int64) - 1, 0),
        ).astype(np.int32)
        return drafts, spec_len


def predicted_acceptance(trace, results: dict, provider, k: int) -> dict:
    """The predicted twin: replay draft-and-verify arithmetic over the
    measured token streams (no model, no device).  For each request, walk
    its final stream: at ``e`` emitted tokens the engine would verify with
    drafts proposed from ``prompt + stream[:e]`` at depth
    ``min(k, max_new - e - 1, draft_len)``; the greedy targets ARE the
    stream, so the accepted prefix length is exact.  Returns
    ``accept_rate`` (accepted drafts / drafted tokens) and
    ``tokens_per_step`` (verify-emitted tokens per verify pass) — the
    measured twins' error vs this is the eviction/recompute re-decode
    traffic the replay cannot see."""
    drafted = accepted = passes = emitted = 0
    window = getattr(provider, "window", None)
    for req in trace:
        stream = results.get(req.uid)
        if not stream:
            continue
        prompt = list(req.prompt)
        e = 1  # the first token is sampled off the prefill logits
        while e < len(stream):
            depth = max(min(k, req.max_new_tokens - e - 1), 0)
            m = 0
            if depth > 0:
                # propose at full k, then clamp — exactly the engine's
                # Speculator.draft order (the provider may pick a different
                # match site for a different k).  Context carries only the
                # provider's trailing window, like the engine's verify tick
                # (a full prompt+stream rebuild per pass is quadratic)
                ctx = prompt + stream[:e] if window is None else \
                    (stream[e - window:e] if e >= window
                     else prompt[e - window:] + stream[:e])
                draft, dl = provider.propose([ctx], k)
                depth = min(depth, int(dl[0]))
                while m < depth and e + m < len(stream) \
                        and int(draft[0, m]) == stream[e + m]:
                    m += 1
            out = min(m + 1, len(stream) - e)
            drafted += depth
            accepted += m
            emitted += out
            passes += 1
            e += out
    return {
        "accept_rate": round(accepted / drafted, 4) if drafted else 0.0,
        "tokens_per_step": round(emitted / passes, 4) if passes else 0.0,
        "drafted": drafted,
        "accepted": accepted,
        "verify_passes": passes,
    }


def speculative_page_need(kv_tokens: int, depth: int, page_size: int) -> int:
    """Worst-case fresh pages one slot's verify pass can consume: page
    starts among the written positions ``[kv, kv + depth]``."""
    from .paged_cache import pages_for

    return int(pages_for(kv_tokens + depth + 1, page_size)
               - pages_for(kv_tokens, page_size))


__all__ = [
    "NgramDraft",
    "DraftModelDraft",
    "Speculator",
    "make_draft_provider",
    "predicted_acceptance",
    "speculative_page_need",
]
