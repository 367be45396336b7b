"""Serving runtime: continuous batching over the model decode step.

Iteration-level batching (Orca-style) with fixed shapes: a constant
number of slots equal to the decode batch; every engine step advances
EVERY active slot by exactly one token — a forced prompt token for slots
still in their prefill phase, or the previously sampled token for slots
in generation.  Finished slots (EOS or max tokens) are reset and
immediately reusable; shapes never change, so one decode step serves the
whole workload.

KV-cache layout is chosen with the Shuhai-derived autotuner
(core.autotune.choose_layout): decode sweeps `seq` while fetching
(kv_heads, head_dim) contiguously — the modeled-best layout keeps the
fetched dims minor, exactly how the paper picks an address-mapping policy
from measured curves.

The decode step runs eagerly on the cache's device (the card unless the
caller names the CPU) and writes the cache in place.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Deque, List, Optional

import torch

from repro_torch.core.autotune import choose_layout
from repro_torch.core.oracle import MemoryOracle
from repro_torch.device import resolve_device


@dataclasses.dataclass
class Request:
    rid: int
    prompt: List[int]
    max_new_tokens: int = 32
    generated: List[int] = dataclasses.field(default_factory=list)
    done: bool = False


@dataclasses.dataclass
class _Slot:
    req: Request
    cursor: int = 0      # next prompt token index to feed

    @property
    def prefilling(self) -> bool:
        return self.cursor < len(self.req.prompt)


@dataclasses.dataclass
class ServingStats:
    admitted: int = 0
    completed: int = 0
    engine_steps: int = 0
    decode_tokens: int = 0
    prefill_tokens: int = 0


class ContinuousBatchingEngine:
    def __init__(self, model, params, *, slots: int, max_seq: int,
                 eos_id: int = 0, dtype: torch.dtype = torch.float32,
                 device=None):
        if model.cfg.is_encdec:
            raise ValueError("continuous batching engine serves decoder-only "
                             "models; use EncDecLM.decode_step directly")
        self.model = model
        self.params = params
        self.num_slots = slots
        self.max_seq = max_seq
        self.eos_id = eos_id
        self.device = resolve_device(device)
        cache = model.init_cache(batch_size=slots, max_seq=max_seq,
                                 dtype=dtype, device=self.device)
        self.cache = model.enable_slots(cache, slots)
        self.slots: List[Optional[_Slot]] = [None] * slots
        self.queue: Deque[Request] = deque()
        self.stats = ServingStats()
        cfg = model.cfg
        self.kv_layout = choose_layout(
            MemoryOracle(),
            {"seq": max_seq, "kv_heads": max(1, cfg.num_kv_heads),
             "head_dim": max(1, cfg.head_dim)},
            itemsize=2, iterate_dim="seq",
            fetch_dims=("kv_heads", "head_dim"))

    # ------------------------------------------------------------- intake
    def submit(self, req: Request) -> None:
        if not req.prompt:
            raise ValueError("empty prompt")
        if len(req.prompt) + req.max_new_tokens > self.max_seq:
            raise ValueError("request exceeds max_seq")
        self.queue.append(req)

    def _admit(self) -> None:
        for i in range(self.num_slots):
            if self.slots[i] is None and self.queue:
                req = self.queue.popleft()
                self.cache = self.model.reset_slot(self.cache, i)
                self.slots[i] = _Slot(req=req)
                self.stats.admitted += 1

    # ------------------------------------------------------------- engine
    def step(self) -> None:
        """One engine step: admit, advance every active slot by one token."""
        self._admit()
        if not any(s is not None for s in self.slots):
            return
        feed = [self.eos_id] * self.num_slots
        for i, slot in enumerate(self.slots):
            if slot is None:
                continue
            if slot.prefilling:
                feed[i] = slot.req.prompt[slot.cursor]
            else:
                feed[i] = slot.req.generated[-1]
        tokens = torch.tensor(feed, dtype=torch.int64,
                              device=self.device)[:, None]
        logits, self.cache = self.model.decode_step(self.params, self.cache,
                                                    tokens)
        nxt = logits.argmax(dim=-1).tolist()
        self.stats.engine_steps += 1

        for i, slot in enumerate(self.slots):
            if slot is None:
                # Idle slot decoded garbage at position 0; rewind its cursor
                # so its state stays inert until admission resets it.
                self.cache["slot_pos"][i] = 0
                continue
            if slot.prefilling:
                self.stats.prefill_tokens += 1
                last_prompt = slot.cursor == len(slot.req.prompt) - 1
                slot.cursor += 1
                if last_prompt:
                    self._emit(i, slot, int(nxt[i]))
            else:
                self._emit(i, slot, int(nxt[i]))

    def _emit(self, i: int, slot: _Slot, tok: int) -> None:
        slot.req.generated.append(tok)
        self.stats.decode_tokens += 1
        if tok == self.eos_id or len(slot.req.generated) >= \
                slot.req.max_new_tokens:
            slot.req.done = True
            self.stats.completed += 1
            self.slots[i] = None

    def run_until_drained(self, max_steps: int = 10_000) -> ServingStats:
        steps = 0
        while (self.queue or any(s is not None for s in self.slots)) \
                and steps < max_steps:
            self.step()
            steps += 1
        return self.stats
