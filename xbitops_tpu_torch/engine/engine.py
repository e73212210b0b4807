"""Continuous-batching decode engine (port of ``xbitops_tpu/engine/engine.py``).

- a fixed pool of ``slots`` cache slots;
- admission: waiting requests prefill into free slots in one batched forward,
  padded to a bucket length (pad tokens carry position S, so they write
  nothing and advance nothing);
- decode in bursts of ``decode_burst`` steps over all slots with an ``active``
  mask; tokens stay on the device within a burst and are read back once;
- finished slots refill from the queue without draining the batch;
- per-request temperature, eos and max_new_tokens; engine-level top-k/top-p.

PyTorch runs eagerly, so there is nothing to compile or donate: the KV cache
is one tensor pair updated in place.  Not ported yet: the int8 cache, paged
KV, speculative decoding, pipelined bursts, meshes, failure restarts and
chunked admission of prompts longer than the last bucket.
"""

from __future__ import annotations

import dataclasses
import time
from collections import defaultdict, deque
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from xbitops_tpu_torch.engine.sampling import sample_tokens
from xbitops_tpu_torch.models import llama


@dataclasses.dataclass
class Request:
    """One generation request."""

    prompt: Sequence[int]
    max_new_tokens: int = 64
    temperature: float = 0.0
    eos_id: Optional[int] = None
    id: Optional[int] = None


@dataclasses.dataclass
class Completion:
    id: int
    prompt_len: int
    tokens: List[int]  # generated tokens (eos included if hit)
    finish_reason: str  # "eos" | "length" | "capacity"


def default_buckets(max_seq_len: int) -> List[int]:
    b, out = 16, []
    while b < max_seq_len:
        out.append(b)
        b *= 2
    out.append(max_seq_len)
    return out


class Engine:
    """Continuous-batching engine over a packed :class:`~llama.Llama`."""

    def __init__(
        self,
        model: llama.Llama,
        cfg: llama.LlamaConfig,
        slots: int = 8,
        prefill_buckets: Optional[Sequence[int]] = None,
        top_k: int = 0,
        top_p: float = 1.0,
        seed: int = 0,
        cache_dtype=torch.bfloat16,
        decode_burst: int = 1,
        prefill_chunk: int = 512,
        kv_quant: Optional[bool] = None,
        spec_tokens: int = 0,
        paged: bool = False,
        pipeline: int = 0,
        mesh=None,
        draft_params=None,
        max_restarts: int = 0,
    ):
        """``kv_quant=None`` means the bf16 cache, until the int8 cache is
        ported (the JAX package's automatic choice was measured on a TPU).
        ``seed`` seeds the engine's ``torch.Generator`` for sampled rows."""
        unported = dict(
            kv_quant=kv_quant is True, spec_tokens=spec_tokens > 0, paged=paged,
            pipeline=bool(pipeline), mesh=mesh is not None,
            draft_params=draft_params is not None, max_restarts=max_restarts > 0,
        )
        for name, used in unported.items():
            if used:
                raise NotImplementedError(f"Engine({name}=...) is not ported yet")
        if cfg != model.cfg:
            raise ValueError("cfg differs from the model's config")
        self.model = model
        self.cfg = cfg
        self.slots = slots
        self.prefill_chunk = min(prefill_chunk, cfg.max_seq_len)
        self.buckets = sorted(
            b for b in (prefill_buckets or default_buckets(cfg.max_seq_len))
            if b <= self.prefill_chunk
        ) or [self.prefill_chunk]
        self.decode_burst = max(1, decode_burst)
        self.top_k, self.top_p = top_k, top_p
        self.device = model.device
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.cache = llama.KVCache.init(cfg, slots, self.device, dtype=cache_dtype)
        self._next_id = 0
        self.loop_stats = defaultdict(float)

    def _bucket(self, n: int) -> int:
        for b in self.buckets:
            if b >= n:
                return b
        raise ValueError(f"prompt length {n} exceeds max bucket {self.buckets[-1]}")

    def _sample(self, logits: torch.Tensor, temps: torch.Tensor, greedy: bool):
        if greedy:  # all rows greedy: plain argmax, no randomness consumed
            return logits.float().argmax(dim=-1).to(torch.int32)
        return sample_tokens(logits, self.generator, temps, self.top_k, self.top_p)

    @torch.no_grad()
    def generate(
        self,
        requests: Sequence[Request],
        on_token: Optional[Callable[[int, int], None]] = None,
    ) -> List[Completion]:
        """Run all requests to completion; slots refill as they free."""
        S = self.cfg.max_seq_len
        dev = self.device
        pending = deque()
        for r in requests:
            if r.id is None:
                r = dataclasses.replace(r, id=self._next_id)
            self._next_id = max(self._next_id, r.id + 1)
            if len(r.prompt) >= S:
                raise ValueError(f"prompt length {len(r.prompt)} >= max_seq_len {S}")
            if len(r.prompt) > self.buckets[-1]:
                raise NotImplementedError(
                    f"prompt length {len(r.prompt)} > last bucket {self.buckets[-1]}: "
                    "chunked admission (prefill_attention) is not ported yet")
            pending.append(r)

        slot_req: List[Optional[Request]] = [None] * self.slots
        slot_gen: List[List[int]] = [[] for _ in range(self.slots)]
        slot_len = np.zeros(self.slots, np.int64)  # prompt + generated
        cur_tok = np.zeros(self.slots, np.int32)
        temps = np.zeros(self.slots, np.float32)
        active = np.zeros(self.slots, bool)
        done: List[Completion] = []
        lt = self.loop_stats = defaultdict(float)

        def finish(b: int, reason: str):
            r = slot_req[b]
            done.append(Completion(r.id, len(r.prompt), slot_gen[b], reason))
            slot_req[b] = None
            slot_gen[b] = []
            active[b] = False

        def accept(b: int, tok: int) -> None:
            r = slot_req[b]
            slot_gen[b].append(tok)
            slot_len[b] += 1
            if on_token is not None:
                on_token(r.id, tok)
            if r.eos_id is not None and tok == r.eos_id:
                finish(b, "eos")
            elif len(slot_gen[b]) >= r.max_new_tokens:
                finish(b, "length")
            elif slot_len[b] >= S:
                finish(b, "capacity")
            else:
                cur_tok[b] = tok

        while pending or active.any():
            t_mark = time.perf_counter()
            admit = []
            for b in range(self.slots):
                if not active[b] and pending:
                    r = pending.popleft()
                    admit.append((b, r, list(r.prompt)))
            if admit:
                bucket = self._bucket(max(len(p) for _, _, p in admit))
                tokens = np.zeros((len(admit), bucket), np.int64)
                for i, (_, _, prompt) in enumerate(admit):
                    tokens[i, : len(prompt)] = prompt
                lens = torch.tensor([len(p) for _, _, p in admit], device=dev)
                slots = torch.tensor([b for b, _, _ in admit], device=dev)
                t_adm = [r.temperature for _, r, _ in admit]
                logits, _ = llama.prefill_slots(
                    self.model, torch.from_numpy(tokens).to(dev), lens, slots, self.cache)
                toks = self._sample(logits, torch.tensor(t_adm, device=dev),
                                    greedy=max(t_adm) <= 0).cpu().numpy()
                for i, (b, r, prompt) in enumerate(admit):
                    slot_req[b] = r
                    slot_gen[b] = []
                    slot_len[b] = len(prompt)
                    temps[b] = r.temperature
                    active[b] = True
                    accept(b, int(toks[i]))
                lt["admit_prefill"] += time.perf_counter() - t_mark
            if not active.any():
                continue

            t_mark = time.perf_counter()
            step_active = active.copy()
            act_dev = torch.from_numpy(step_active).to(dev)
            temps_dev = torch.from_numpy(temps).to(dev)
            greedy = not (temps[step_active] > 0).any()
            tok_dev = torch.from_numpy(cur_tok).to(dev)
            seq = []
            for _ in range(self.decode_burst):
                logits, _ = llama.decode_step(self.model, tok_dev, self.cache, active=act_dev)
                tok_dev = torch.where(act_dev, self._sample(logits, temps_dev, greedy), 0)
                seq.append(tok_dev)
            toks = torch.stack(seq).cpu().numpy()  # [burst, slots]; syncs
            lt["decode"] += time.perf_counter() - t_mark
            lt["decode_steps"] += self.decode_burst
            for step in range(toks.shape[0]):
                for b in range(self.slots):
                    if step_active[b] and active[b]:
                        accept(b, int(toks[step, b]))
                        lt["decode_tokens"] += 1
                if not active.any():
                    break  # the rest of the burst is garbage for every slot
        return sorted(done, key=lambda c: c.id)
