"""The serving engine: paged-KV decode + continuous batching over one model
(mirrors ``accelerate_tpu/serving/engine.py``).

Where :func:`~accelerate_tpu_torch.generation.generate` runs one fixed
batch start to finish, the engine keeps a fixed set of decode slots and a
fixed-size page pool busy under live traffic: requests are admitted,
chunk-prefilled, decoded and retired per step.

Each tick runs at most one device step — ``decode_step`` (one token for
every slot), ``prefill_step`` (one bucket-padded chunk of one prompt) or
``release_step`` — and fetches at most one token to the host.  PyTorch runs
eagerly: there is no jit, and no donation; the KV pool, block tables and
free stack are updated **in place**.  With ``decode_kernel`` ``"flash"``
(what ``"auto"`` means) the model's attention goes through the hand-written
paged kernels on the card (``ops/flash_attention.py``).  Greedy serving
emits tokens identical to ``generate()``.

Speculative decode, prefix caching, quantized pages, multi-tenant adapters,
telemetry spans, fault plans and the overload ladder are later items of
ROADMAP Queue A (A11) and Queue B; the engine raises
``NotImplementedError`` when a plugin switches one on.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from ..generation import GenerationConfig, sample_logits
from ..models.llama import init_paged_cache
from ..utils.dataclasses import ServingPlugin
from ..utils.device import resolve_device
from .paged_cache import allocate, release
from .scheduler import ContinuousBatchingScheduler, Request


def _reject_later_slice_knobs(p: ServingPlugin) -> None:
    if p.speculate != "off":
        raise NotImplementedError(
            f"ServingPlugin.speculate={p.speculate!r}: speculative decode is "
            "ROADMAP Queue A item A11 (with the verify shape of kernel #6)")
    if p.prefix_cache == "on":
        raise NotImplementedError(
            "ServingPlugin.prefix_cache='on': prefix caching is ROADMAP Queue A item A11")
    if p.kv_dtype != "bf16":
        raise NotImplementedError(
            f"ServingPlugin.kv_dtype={p.kv_dtype!r}: quantized KV pages come "
            "with ROADMAP Queue B kernels #5/#7")
    if p.max_queue or p.kv_shed_watermark or p.default_deadline_ticks:
        raise NotImplementedError(
            "ServingPlugin.max_queue / kv_shed_watermark / default_deadline_ticks: "
            "the overload ladder is ROADMAP Queue A item A11")


class ServingEngine:
    """Continuous-batching serving over one model.

    >>> engine = ServingEngine(model, plugin, generation_config)
    >>> engine.add_request(Request(uid=0, prompt=(1, 2, 3), max_new_tokens=8))
    >>> while not engine.idle():
    ...     engine.step()
    >>> engine.results[0]  # generated token ids

    ``device`` defaults to ``"cuda"`` (raises without one); the model must
    live there.  ``seed`` seeds the per-step sampling generator.
    ``run(trace)`` replays a list of :class:`~.scheduler.Request` with
    virtual-time arrivals.
    """

    def __init__(self, model, plugin: Optional[ServingPlugin] = None,
                 generation_config: Optional[GenerationConfig] = None, *,
                 seed: int = 0, device=None):
        self.device = resolve_device(device)
        if model.device.type != self.device.type or (
                self.device.index is not None and model.device.index != self.device.index):
            raise ValueError(f"the model lives on {model.device}, the engine on {self.device}")
        self.plugin = plugin or ServingPlugin()
        self.gen_config = generation_config or GenerationConfig()
        p = self.plugin
        _reject_later_slice_knobs(p)
        # "auto" -> the paged kernels: CUDA kernels on the card, their plain
        # versions on a CPU tensor; "native" only when asked for
        self.attn_implementation = "flash" if p.decode_kernel == "auto" else p.decode_kernel
        self.model = model
        self.cache = init_paged_cache(model.config, p.num_pages, p.page_size,
                                      p.num_slots, p.pages_per_slot, device=self.device)
        self.sched = ContinuousBatchingScheduler(
            p.num_slots, p.num_pages, p.page_size, p.pages_per_slot,
            p.prefill_chunk, p.prefill_buckets,
        )
        self._seed = seed
        self._generator = torch.Generator(device=self.device)
        self.warmed_up = False
        self.steps = 0
        self.results: dict[int, list[int]] = {}
        self._arrival_wall: dict[int, float] = {}
        self._last_token_wall: dict[int, float] = {}
        self._ttft_seen: set[int] = set()
        self.metrics = {
            "decode_steps": 0, "prefill_steps": 0, "idle_steps": 0,
            "scheduled_decode_slots": 0, "useful_decode_tokens": 0,
            "prefill_scheduled_tokens": 0, "prefill_useful_tokens": 0,
            "evictions": 0, "page_step_sum": 0, "peak_used_pages": 0,
            "prompt_tokens": 0, "generated_tokens": 0,
            "decode_lane_passes": 0, "decode_emitted_tokens": 0,
        }
        self.ttft_s: list[float] = []
        # TTFT in virtual engine ticks (arrival -> first token)
        self.ttft_ticks: list[int] = []
        self.token_gaps_s: list[float] = []

    # -- device steps (in place on self.cache) --------------------------------

    def _layer_caches(self, block_tables):
        return [{"k_pages": l["k_pages"], "v_pages": l["v_pages"],
                 "block_tables": block_tables} for l in self.cache["layers"]]

    @torch.inference_mode()
    def decode_step(self, tokens: np.ndarray, active: np.ndarray) -> torch.Tensor:
        """One token for every slot at once; dead slots write nowhere and
        their sampled token is ignored.  Pops a page for each active slot
        whose next position starts one.  Returns the sampled tokens [S]."""
        cache, page = self.cache, self.plugin.page_size
        tokens_t = torch.from_numpy(tokens).to(self.device)
        active_t = torch.from_numpy(active).to(self.device)
        pos = cache["seq_lens"]
        n_slots = tokens_t.shape[0]
        need = active_t & (pos % page == 0)
        block_tables, cache["free_top"] = allocate(
            cache["block_tables"], cache["free_stack"], cache["free_top"],
            torch.arange(n_slots, device=self.device), pos // page, need,
        )
        logits, _ = self.model(
            tokens_t[:, None], positions=pos[:, None],
            cache=self._layer_caches(block_tables), cache_write_mask=active_t[:, None],
            attn_implementation=self.attn_implementation,
        )
        next_tok = sample_logits(logits[:, 0], self._step_generator(), self.gen_config)
        cache["seq_lens"] = pos + active_t.to(torch.int32)
        return next_tok

    @torch.inference_mode()
    def prefill_step(self, slot: int, chunk_ids: np.ndarray, start: int,
                     chunk_len: int) -> torch.Tensor:
        """One bucket-padded chunk of one sequence's prompt.  Returns the
        logits of the chunk's last real token (the decode-loop seed once
        the prompt completes)."""
        cache, page = self.cache, self.plugin.page_size
        width = chunk_ids.shape[0]
        lane = torch.arange(width, device=self.device, dtype=torch.int32)
        positions = start + lane
        wmask = lane < chunk_len
        need = wmask & (positions % page == 0)
        block_tables, cache["free_top"] = allocate(
            cache["block_tables"], cache["free_stack"], cache["free_top"],
            torch.full((width,), slot, device=self.device), positions // page, need,
        )
        logits, _ = self.model(
            torch.from_numpy(chunk_ids).to(self.device)[None], positions=positions[None],
            cache=self._layer_caches(block_tables[slot:slot + 1]),
            cache_write_mask=wmask[None], attn_implementation=self.attn_implementation,
        )
        cache["seq_lens"][slot] = start + chunk_len
        return logits[0, chunk_len - 1]

    @torch.inference_mode()
    def release_step(self, mask: np.ndarray) -> None:
        """Push every page of the masked slots back onto the free stack and
        zero their lengths."""
        cache = self.cache
        cache["seq_lens"], cache["free_stack"], cache["free_top"] = release(
            cache["block_tables"], cache["seq_lens"], cache["free_stack"],
            cache["free_top"], torch.from_numpy(mask).to(self.device),
            self.plugin.page_size,
        )

    @torch.inference_mode()
    def sample_first(self, last: torch.Tensor) -> torch.Tensor:
        return sample_logits(last[None], self._step_generator(), self.gen_config)[0]

    def _step_generator(self) -> torch.Generator:
        # one stream per (seed, tick): the JAX engine's fold_in(rng, steps)
        return self._generator.manual_seed((self._seed << 32) + self.steps)

    # -- request lifecycle ---------------------------------------------------

    def add_request(self, request: Request) -> None:
        self.sched.submit(request)
        self._arrival_wall[request.uid] = time.perf_counter()

    def idle(self) -> bool:
        return self.sched.idle()

    # -- the engine tick -----------------------------------------------------

    def warmup(self) -> None:
        """Run every device step once before taking traffic — decode,
        release and each bucket's prefill (plus the first-token sampler) —
        as no-ops: decode with zero active slots, a zero-length chunk into
        an idle slot, an empty release mask.  This builds the CUDA kernels
        and brings up cuBLAS before the first request's clock starts.
        Tokens are never recorded and ``steps`` does not advance."""
        if self.sched.slots:
            raise RuntimeError("warmup() must run before any traffic is admitted")
        n = self.plugin.num_slots
        self.decode_step(np.zeros((n,), np.int32), np.zeros((n,), bool))
        last = None
        for bucket in self.plugin.prefill_buckets:
            last = self.prefill_step(0, np.zeros((bucket,), np.int32), 0, 0)
        if last is not None:
            self.sample_first(last)
        self.release_step(np.zeros((n,), bool))
        self.decode_step(np.zeros((n,), np.int32), np.zeros((n,), bool))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.warmed_up = True

    def step(self) -> dict:
        """One scheduler decision + at most one device step."""
        self.sched.admit()
        action = self.sched.next_action()
        event: dict = {"type": action[0], "step": self.steps}
        m = self.metrics
        if action[0] == "prefill":
            _, slot, start, chunk, bucket = action
            survived, evicted = self.sched.plan_prefill_evictions(slot, chunk)
            self._release_evicted(evicted)
            if survived:
                st = self.sched.slots[slot]
                ids = np.zeros((bucket,), np.int32)
                ids[:chunk] = st.request.prompt[start:start + chunk]
                last = self.prefill_step(slot, ids, start, chunk)
                self.sched.note_prefill(slot, chunk)
                m["prefill_steps"] += 1
                m["prefill_scheduled_tokens"] += bucket
                m["prefill_useful_tokens"] += chunk
                m["prompt_tokens"] += chunk
                event.update(slot=slot, chunk=chunk, bucket=bucket)
                if st.prefill_done:
                    # the prompt's last-token logits seed the decode loop —
                    # the first generated token, exactly like generate()
                    tok = int(self.sample_first(last))
                    m["generated_tokens"] += 1
                    self._record_token(slot, tok)
            else:
                event["cancelled"] = True
        elif action[0] == "decode":
            active_slots, evicted = self.sched.plan_evictions(action[1])
            self._release_evicted(evicted)
            if active_slots:
                needing = self.sched.decode_page_need(active_slots)
                n = self.plugin.num_slots
                tokens = np.zeros((n,), np.int32)
                active = np.zeros((n,), bool)
                for s in active_slots:
                    tokens[s] = self.sched.slots[s].tokens[-1]
                    active[s] = True
                next_tok = self.decode_step(tokens, active)
                self.sched.note_decode(needing)
                next_np = next_tok.cpu().numpy()  # the tick's one host sync
                done_slots = [s for s in active_slots
                              if self._record_token(s, int(next_np[s]), release=False)]
                if done_slots:
                    self._release_slots(done_slots)
                    for s in done_slots:
                        self.sched.finish(s)
                m["decode_steps"] += 1
                m["scheduled_decode_slots"] += n
                m["useful_decode_tokens"] += len(active_slots)
                m["generated_tokens"] += len(active_slots)
                m["decode_lane_passes"] += len(active_slots)
                m["decode_emitted_tokens"] += len(active_slots)
                event.update(slots=tuple(active_slots))
            else:
                event["cancelled"] = True
        else:
            m["idle_steps"] += 1
        used = self.sched.used_pages
        m["page_step_sum"] += used
        m["peak_used_pages"] = max(m["peak_used_pages"], used)
        self.steps += 1
        return event

    def run(self, trace: list[Request], max_steps: int = 200_000) -> dict[int, list[int]]:
        """Replay ``trace`` (arrivals keyed on virtual step time) to
        completion."""
        pending = sorted(trace, key=lambda r: (r.arrival_step, r.uid))
        i = 0
        while True:
            while i < len(pending) and pending[i].arrival_step <= self.steps:
                self.add_request(pending[i])
                i += 1
            if self.idle() and i >= len(pending):
                break
            self.step()
            if self.steps >= max_steps:
                raise RuntimeError(f"serving replay exceeded {max_steps} steps")
        return self.results

    # -- internals -----------------------------------------------------------

    def _record_token(self, slot: int, tok: int, release: bool = True) -> bool:
        """Append a sampled token; retire the sequence on EOS/max_new.
        Returns True when the sequence finished (the caller releases if it
        opted out of the immediate release)."""
        st = self.sched.slots[slot]
        now = time.perf_counter()
        uid = st.request.uid
        if not st.tokens:
            # once per request: an evicted-and-readmitted sequence must not
            # re-sample its TTFT
            if uid not in self._ttft_seen:
                self._ttft_seen.add(uid)
                self.ttft_s.append(now - self._arrival_wall[uid])
                self.ttft_ticks.append(self.steps - st.request.arrival_step)
        elif uid in self._last_token_wall:
            self.token_gaps_s.append(now - self._last_token_wall[uid])
        self._last_token_wall[uid] = now
        st.tokens.append(tok)
        if not st.prefill_done:
            raise AssertionError("token recorded before prefill completed")
        eos = self.gen_config.eos_token_id
        finished = (eos is not None and tok == eos) or \
            len(st.tokens) >= st.request.max_new_tokens
        if finished:
            self.results[uid] = list(st.tokens)
            self._arrival_wall.pop(uid, None)
            self._last_token_wall.pop(uid, None)
            self._ttft_seen.discard(uid)
            if release:
                self._release_slots([slot])
                self.sched.finish(slot)
            return True
        return False

    def _release_slots(self, slots: list[int]) -> None:
        mask = np.zeros((self.plugin.num_slots,), bool)
        mask[slots] = True
        self.release_step(mask)

    def _release_evicted(self, evicted: list[int]) -> None:
        if evicted:
            self._release_slots(evicted)
            self.metrics["evictions"] += len(evicted)
            # the evicted sequences' generated tokens were revoked: their
            # inter-token clock must not bridge across the readmission
            for req in self.sched.waiting:
                self._last_token_wall.pop(req.uid, None)

    # -- introspection --------------------------------------------------------

    def free_page_mirror_in_sync(self) -> bool:
        """The host scheduler's free-page mirror equals the device
        allocator's ``free_top`` (one scalar fetch)."""
        return int(self.cache["free_top"]) == self.sched.free_pages
