"""Continuous-batching decode engine (port of ``xbitops_tpu/engine/engine.py``).

- a fixed pool of ``slots`` cache slots;
- admission: waiting requests prefill into free slots in one batched forward,
  padded to a bucket length (pad tokens carry position S, so they write
  nothing and advance nothing); prompts longer than the last bucket are
  admitted in chunks of ``prefill_chunk`` tokens that attend the cache, all
  long prompts advancing one chunk per forward in lockstep;
- decode in bursts of ``decode_burst`` steps over all slots with an ``active``
  mask; tokens stay on the device within a burst and are read back once;
- finished slots refill from the queue without draining the batch;
- per-request temperature, eos and max_new_tokens; engine-level top-k/top-p;
- ``paged=True``: the KV cache is a pool of pages shared by the slots.  A host
  allocator gives a slot the pages its prompt needs at admission and the
  pages of its next burst before each burst, and takes them back when the
  request finishes; a request waits while the pool cannot back its prompt,
  and a slot the pool cannot serve sits a burst out;
- ``max_restarts``: a device error rebuilds the cache and requeues every
  request in flight as its prompt plus the tokens it has emitted;
- ``spec_tokens=γ``: speculative decoding, greedy only.  Each step drafts γ
  tokens a slot, from the slot's own history (n-gram) or from a small draft
  model (``draft_params``, with a bf16 cache of its own that every admission
  prefills beside the target's), and verifies them in one forward of γ + 1
  rows a slot (``llama.spec_verify_step``): the emitted stream is the plain
  greedy one, and each accepted draft saves a step;
- ``pipeline=N``: up to N bursts in flight; the host takes a burst's tokens
  while the next ones run, and continuing slots take their next input from
  the newest burst's last tokens on the device.

A burst is one Python function (:meth:`Engine._burst`) over static device
buffers: the tokens, the ``active`` mask and the temperatures are copied in,
and the ``[burst, slots]`` tokens come out of one buffer the host reads once.
A speculative step is another such function (:meth:`Engine._spec`): the
tokens to verify ``[slots, γ + 1]`` and the mask in, the verified tokens, the
model's greedy tokens and the accepted counts out of one buffer; with a draft
model its chain runs inside it, so drafts reach the host only once verified.
On a CUDA device each program (greedy, sampled, or speculative) is captured
once as a CUDA graph, lazily at its first use, and every burst or step is a
replay of it: the counterpart of the JAX package's jitted programs.  On the
CPU the same functions run eagerly.  The KV cache (bf16, or packed int8 with
``kv_quant``) is one set of tensors updated in place, and a replay writes the
addresses it captured: nothing may rebind a cache tensor while a graph
holds it, and a restart drops the graphs with the caches.  Host inputs go up
through pinned memory without blocking, and a burst's tokens come back the
same way, so that pipelined bursts overlap the host.

``mesh=`` (tensor parallelism, one process a rank): every rank builds the
engine on the same model packed for the mesh's ``axis`` and runs the same
``generate`` on the same requests.  The engine keeps the rank's shard
(``parallel.model_tp.shard_params``: an ordinary :class:`~llama.Llama` of
``cfg.local(tp)`` whose row projections sum over the axis and whose lm_head
gathers) and a cache of the rank's kv heads; its forwards are ``model_tp``'s
``tp_*`` functions on that shard, so every rank holds the same logits and
samples the same tokens.  A mesh engine runs its bursts and
speculative steps eagerly, never as graphs (``loop_stats["graph_captures"]``
stays 0): a gloo collective syncs through the host, which a CUDA graph cannot
capture, and NCCL inside a graph needs a card a rank.
"""

from __future__ import annotations

import dataclasses
import time
from collections import defaultdict, deque
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from xbitops_tpu_torch.engine.sampling import sample_tokens
from xbitops_tpu_torch.kernels import common
from xbitops_tpu_torch.models import llama
from xbitops_tpu_torch.utils import tracing


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


# Smallest max_seq_len at which ``kv_quant=None`` picks the int8 cache.  The
# value is the JAX package's, measured on a TPU v5e; it is kept for parity
# until the H100 re-derives it.
AUTO_KV_QUANT_MIN_S = 1024

# The errors a restart recovers from: the device's, never a Python bug.
DEVICE_ERRORS = (torch.AcceleratorError, torch.OutOfMemoryError)


@dataclasses.dataclass
class _Program:
    """A captured burst or speculative step: its graph and the kernel launches
    one replay makes (the wrappers count when they run, and a replay runs none
    of them)."""

    graph: "torch.cuda.CUDAGraph"
    launches: dict


@dataclasses.dataclass
class _InFlight:
    """A burst on its way to the host: its tokens' copy (pinned host memory
    on a CUDA engine) with the event that completes it, CUDA events around
    its replay, and the slots it ran with the occupants it ran them for."""

    toks: torch.Tensor
    done: Optional["torch.cuda.Event"]
    events: Optional[tuple]
    step_active: np.ndarray
    epochs: np.ndarray

    def wait(self) -> np.ndarray:
        if self.done is not None:
            self.done.synchronize()
        return self.toks.numpy()


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
        pool_pages: Optional[int] = None,
        page_size: int = 256,
        pipeline: int = 0,
        mesh=None,
        axis: str = "model",
        device=None,
        draft_params: Optional[llama.Llama] = None,
        draft_cfg: Optional[llama.LlamaConfig] = None,
        max_restarts: int = 0,
    ):
        """``cache_dtype``: the dense KV cache's rows, ``torch.bfloat16``,
        ``torch.float16`` or ``torch.float32`` (the draft model's cache too;
        activations stay bf16).  ``kv_quant``: True for the packed int8 KV
        cache, False for the dense one; None picks int8 for long contexts
        (``max_seq_len >= AUTO_KV_QUANT_MIN_S``) where the cache allows it and
        ``cache_dtype`` is bf16, and the dense cache for a paged cache, as the
        JAX package does.  ``prefill_chunk``:
        the longest bucket, and the chunk length for longer prompts.
        ``seed`` seeds the engine's ``torch.Generator`` for sampled rows.

        ``paged=True`` keeps the KV cache as a shared pool of ``pool_pages``
        pages of ``page_size`` positions with a page table per slot, so the
        slots together hold ``pool_pages * page_size`` positions instead of
        ``slots * max_seq_len``; ``pool_pages`` defaults to the pages that
        would be, ``slots * max_seq_len // page_size``.  ``page_size=256`` is
        the JAX package's default.

        ``max_restarts`` > 0 recovers from device errors (``DEVICE_ERRORS``)
        that many times: the cache is rebuilt and every request in flight is
        requeued as its prompt plus the tokens it has emitted, which its
        completion keeps.  Greedy requests resume with the tokens a fault-free
        run gives; sampled ones draw anew from where they stopped.

        ``spec_tokens=γ`` > 0 decodes speculatively: each step drafts γ tokens
        a slot and verifies them in one forward; ``spec_stats`` counts the
        drafted and accepted tokens.  The draft continues the most recent
        earlier occurrence of the slot's last two tokens in its own history
        (n-gram), or with ``draft_params`` comes from γ greedy steps of that
        draft model (a :class:`~llama.Llama` of the target's ``max_seq_len``
        and at least its vocabulary; not with ``paged``).  ``draft_cfg`` is
        redundant, since the draft carries its config: it is taken for the
        JAX package's signature and, where given, must equal it.  Greedy requests only, and exclusive with
        ``decode_burst > 1`` and ``pipeline``.  The stream is the plain greedy
        one up to the bf16 rounding of a forward of γ + 1 rows against one row.

        ``pipeline=N`` keeps up to N bursts in flight: the host accepts one
        burst's tokens while the next run, and a slot's bookkeeping trails its
        device state by up to N bursts (a finished slot may decode N more
        bursts, whose tokens are dropped).  The tokens are the synchronous
        engine's.  It is kept for parity: on one H100 replayed bursts leave
        the host little to overlap, and it has measured slower than
        ``pipeline=0`` (``PERF.md``).

        ``mesh`` (a ``parallel.mesh.Mesh``): tensor-parallel over its ``axis``
        (module docstring); ``model`` is packed for that many ranks
        (``init_params(tp=)``, ``load_autogptq(tp=)``, ``load_llama(tp=)``,
        ``model_tp.pack_for_tp``).  ``kv_quant=None`` then picks bf16, as the
        JAX package does; a draft model is refused.  ``device`` (with
        ``mesh`` only): where the rank's shard and cache go (None: the
        model's device).  A model loaded on the CPU is then never whole on
        the card: a rank's card holds its shard (its columns and row shards,
        the embedding and the norms whole) and its cache."""
        if cfg != model.cfg:
            raise ValueError("cfg differs from the model's config")
        common.check_kv_dtype(cache_dtype)
        self.mesh = mesh
        if mesh is not None and draft_params is not None:
            raise ValueError("draft-model speculation supports mesh=None, paged=False")
        self.spec_tokens = max(0, spec_tokens)
        self.pipeline = int(pipeline)  # bursts in flight (0: synchronous)
        if self.spec_tokens and decode_burst > 1:
            raise ValueError("spec_tokens and decode_burst > 1 are exclusive")
        if self.spec_tokens and self.pipeline:
            raise ValueError("spec_tokens and pipeline are exclusive")
        self.draft = draft_params
        if draft_params is not None:
            if not self.spec_tokens:
                raise ValueError("draft_params requires spec_tokens > 0")
            if draft_cfg is not None and draft_cfg != draft_params.cfg:
                raise ValueError("draft_cfg differs from the draft model's config")
            if paged:
                raise ValueError("draft-model speculation supports paged=False")
            if draft_params.cfg.vocab_size < cfg.vocab_size:
                raise ValueError("draft model must cover the target vocab")
            if draft_params.cfg.max_seq_len != cfg.max_seq_len:
                raise ValueError("the draft model's max_seq_len must equal the target's (the "
                                 "draft cache mirrors the target's positions)")
        self.spec_stats = {
            "drafted": 0, "accepted": 0,
            "draft_source": (("model" if self.draft is not None else "ngram")
                             if self.spec_tokens else None),
        }
        self._steps = llama  # the step functions of the target model
        if mesh is not None:
            from xbitops_tpu_torch.parallel import model_tp

            model = model_tp.shard_params(model, mesh, axis)
            if device is not None:
                model = model.to(device)
            self._steps = model_tp.step_functions(cfg, mesh, axis)
        elif device is not None:
            raise ValueError("device= places a mesh engine's shard; move the model itself")
        self.model = model
        self.cfg = cfg
        self.slots = slots
        self.prefill_chunk = min(prefill_chunk, cfg.max_seq_len)
        self.buckets = sorted(
            b for b in (prefill_buckets or default_buckets(cfg.max_seq_len))
            if b <= self.prefill_chunk
        ) or [self.prefill_chunk]
        if kv_quant is None:
            kv_quant = (
                not paged  # the reference's rule
                and mesh is None
                and cache_dtype == torch.bfloat16
                and cfg.max_seq_len % 4 == 0
                and self.prefill_chunk % 4 == 0
                and cfg.flash_decode and cfg.head_dim % 128 == 0
                and cfg.max_seq_len >= AUTO_KV_QUANT_MIN_S
            )
        self.kv_quant = bool(kv_quant)
        if self.kv_quant:
            # the packed int8 cache is written in whole 4-position words:
            # every prefill length must be a multiple of 4
            self.buckets = sorted({-(-b // 4) * 4 for b in self.buckets})
            if self.prefill_chunk % 4:
                raise ValueError("kv_quant requires prefill_chunk % 4 == 0")
        self.decode_burst = max(1, decode_burst)
        self.top_k, self.top_p = top_k, top_p
        self.device = model.device
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.paged = paged
        if paged:
            if self.kv_quant and page_size % 4:
                raise ValueError("paged int8 KV needs page_size % 4 == 0")
            if not cfg.flash_decode or cfg.head_dim % 128:
                raise ValueError("paged KV requires the flash decode kernel")
            if cfg.max_seq_len % page_size:
                raise ValueError("max_seq_len must be a multiple of page_size")
            self.page_size = page_size
            self.pool_pages = pool_pages or slots * (cfg.max_seq_len // page_size)
        self.cache_dtype = cache_dtype
        self.cache = self._new_cache()
        self.max_restarts = max(0, max_restarts)
        self.restarts = 0
        self._fault_hook = None  # tests inject device errors before a decode dispatch
        # the burst's static buffers: what a captured graph reads and writes
        dev = self.device
        self._tok_in = torch.zeros(slots, dtype=torch.int32, device=dev)
        self._act_in = torch.zeros(slots, dtype=torch.bool, device=dev)
        self._temps_in = torch.zeros(slots, dtype=torch.float32, device=dev)
        self._cont_in = torch.zeros(slots, dtype=torch.bool, device=dev)
        self._burst_out = torch.zeros((self.decode_burst, slots), dtype=torch.int32, device=dev)
        # a speculative step's: the tokens to verify in; those, the greedy
        # tokens and the accepted counts out of one buffer (one read-back)
        g = self.spec_tokens
        self._spec_in = torch.zeros((slots, g + 1), dtype=torch.int32, device=dev)
        self._spec_out = torch.zeros((slots, 2 * g + 3), dtype=torch.int32, device=dev)
        # True (greedy burst), False (sampled) or "spec" -> _Program, captured
        # at its first use
        self._programs: dict = {}
        self._pool = None  # one memory pool for all of the engine's graphs
        # True runs a CUDA engine's bursts eagerly, to hold the graphs to it
        self._eager = False
        self._next_id = 0
        self.loop_stats = defaultdict(float)

    def _new_cache(self) -> llama.KVCache:
        """A new cache (the cache factory a restart calls; of the rank's kv
        heads under a mesh), a new draft cache with a draft model, and for a
        paged one an allocator with every page free."""
        cfg, slots = self.model.cfg, self.slots
        if self.draft is not None:
            self._draft_cache = None
            self._draft_cache = llama.KVCache.init(self.draft.cfg, slots, self.device,
                                                   dtype=self.cache_dtype)
        if not self.paged:
            return llama.KVCache.init(cfg, slots, self.device, dtype=self.cache_dtype,
                                      quantized=self.kv_quant)
        self._free_pages = list(range(self.pool_pages))
        self._slot_pages: List[List[int]] = [[] for _ in range(slots)]
        # the table lives on the host; the card's copy follows when it changed
        self._table = np.full((slots, cfg.max_seq_len // self.page_size), -1, np.int32)
        self._table_changed = False
        return llama.KVCache.init_paged(
            cfg, slots, self.pool_pages, self.page_size, device=self.device,
            dtype=self.cache_dtype, quantized=self.kv_quant)

    # --- the page allocator (host side) ---

    def _pages_for(self, b: int, upto: int) -> bool:
        """Give slot ``b`` the pages that cover positions [0, upto); False if
        the pool cannot right now (the caller lets the slot wait)."""
        need = min(-(-upto // self.page_size), self._table.shape[1])  # capacity caps the rest
        have = len(self._slot_pages[b])
        if need - have > len(self._free_pages):
            return False
        for i in range(have, need):
            p = self._free_pages.pop()
            self._table[b, i] = p
            self._slot_pages[b].append(p)
            self._table_changed = True
        return True

    def _release_pages(self, b: int) -> None:
        if self._slot_pages[b]:
            self._table_changed = True
        self._free_pages.extend(self._slot_pages[b])
        self._slot_pages[b] = []
        self._table[b, :] = -1

    def _push_table(self) -> None:
        """Copy the table to the card if the allocator changed it.  The copy is
        queued behind the forwards already on the stream and the host does not
        wait for it."""
        if self._table_changed:
            self._upload(self.cache.page_table, self._table)
            self._table_changed = False

    @staticmethod
    def _upload(dst: torch.Tensor, arr: np.ndarray) -> None:
        """Copy a host array into a device buffer, queued on the stream: on a
        CUDA device through pinned memory, which the caching host allocator
        keeps until the copy has run, so the host neither waits nor may
        overwrite what the copy reads."""
        src = torch.from_numpy(arr)
        if dst.is_cuda:
            src = src.pin_memory()
        dst.copy_(src, non_blocking=True)

    @staticmethod
    def _fetch(src: torch.Tensor):
        """Start copying a device buffer to the host; returns the host tensor
        and, on a CUDA device, the event after which it holds the values."""
        if not src.is_cuda:
            return src.clone(), None
        host = torch.empty(src.shape, dtype=src.dtype, pin_memory=True)
        host.copy_(src, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        return host, done

    @staticmethod
    def _draft(hist, gamma):
        """n-gram (prompt-lookup) draft: continue from the most recent earlier
        occurrence of the trailing bigram in the slot's own history; pad with
        the last token.  Wrong drafts only cost the already-paid verify slot."""
        out = []
        if len(hist) >= 2:
            a, b = hist[-2], hist[-1]
            for j in range(len(hist) - 3, -1, -1):
                if hist[j] == a and hist[j + 1] == b:
                    out = list(hist[j + 2 : j + 2 + gamma])
                    break
        while len(out) < gamma:
            out.append(hist[-1] if hist else 0)
        return np.asarray(out[:gamma], np.int32)

    def _bucket(self, n: int) -> int:
        for b in self.buckets:
            if b >= n:
                return b
        raise ValueError(f"prompt length {n} exceeds max bucket {self.buckets[-1]}")

    def _sample(self, logits: torch.Tensor, temps: torch.Tensor, greedy: bool):
        if greedy:  # all rows greedy: plain argmax, no randomness consumed
            return logits.float().argmax(dim=-1).to(torch.int32)
        return sample_tokens(logits, self.generator, temps, self.top_k, self.top_p)

    def _burst(self, greedy: bool) -> None:
        """``decode_burst`` chained decode steps from the static inputs (tokens,
        ``active`` mask, temperatures) into ``_burst_out``.  Slots that stop
        mid-burst decode on (the host drops those tokens); inactive slots write
        nothing and advance nothing.  A CUDA engine captures this function and
        replays it; on the CPU it runs as it is."""
        tok, act = self._tok_in, self._act_in
        for i in range(self.decode_burst):
            logits, _ = self._steps.decode_step(self.model, tok, self.cache, active=act)
            tok = torch.where(act, self._sample(logits, self._temps_in, greedy), 0)
            self._burst_out[i].copy_(tok)

    def _spec(self) -> None:
        """One speculative step from the static inputs (``_spec_in``: each
        slot's current token, then its γ drafts; the ``active`` mask) into
        ``_spec_out``.  With a draft model the drafts are made here: its cache
        takes the target's lengths, then γ + 1 greedy draft steps from the
        current token (the last one's token is not used, but its write keeps
        the draft cache whole when every draft is accepted).  Then the target
        verifies.  A CUDA engine captures this function and replays it."""
        g = self.spec_tokens
        toks, act = self._spec_in, self._act_in
        if self.draft is not None:
            d = self._draft_cache
            d.lengths.copy_(torch.where(act, self.cache.lengths, d.lengths))
            tok = toks[:, 0]
            for i in range(g + 1):
                logits, _ = llama.decode_step(self.draft, tok, d, active=act)
                tok = torch.where(act, logits.float().argmax(dim=-1).to(torch.int32), 0)
                if i < g:
                    # a draft past the target's vocabulary could never be
                    # accepted; clamped, it is a token the target can embed
                    toks[:, i + 1].copy_(tok.clamp(max=self.cfg.vocab_size - 1))
        greedy, accepted, _ = self._steps.spec_verify_step(self.model, toks, self.cache, active=act)
        self._spec_out.copy_(torch.cat((toks, greedy, accepted[:, None]), dim=1))

    def _program(self, key) -> Optional[_Program]:
        """The captured graph of a CUDA engine's greedy (``key`` True) or
        sampled (False) burst, or of its speculative step ("spec"), captured
        at its first use; None where they run eagerly (the CPU, a mesh, or
        ``_eager``).  A capture that fails raises: there is no eager fallback.

        Before its capture the function runs once with an all-False mask,
        so that the kernels are built and their lazily made state (the
        library, function attributes, device properties) exists before the
        capture starts.  That run writes nothing to the caches, but it zeros
        ``_act_in`` and the program's outputs (``_burst_out``; ``_spec_out``
        and a draft model's columns of ``_spec_in``): a caller that reads
        them, as a pipelined burst reads ``_burst_out``, does so before this
        call, and sets the inputs after it.  Sampled graphs register the
        engine's generator, so each replay draws new numbers."""
        if self.device.type != "cuda" or self._eager or self.mesh is not None:
            return None
        prog = self._programs.get(key)
        if prog is not None:
            return prog
        if key == "spec":
            body = warm_up = self._spec
        else:  # the greedy body consumes no randomness
            body, warm_up = (lambda: self._burst(key)), (lambda: self._burst(True))
        lt = self.loop_stats
        dev = self.device
        with tracing.span("engine.capture") as cap:
            self._act_in.zero_()
            side = torch.cuda.Stream(dev)
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side):
                warm_up()
            torch.cuda.current_stream(dev).wait_stream(side)
            if self._pool is None:
                self._pool = torch.cuda.graph_pool_handle()
            graph = torch.cuda.CUDAGraph()
            if key is False:
                graph.register_generator_state(self.generator)
            before = dict(common.launches)
            # thread_local: a server captures on its worker thread while others wait
            with torch.cuda.graph(graph, pool=self._pool, capture_error_mode="thread_local"):
                body()
            launches = {k: n - before[k] for k, n in common.launches.items() if n != before[k]}
            common.launches.update(before)  # a capture records launches; it makes none
            prog = self._programs[key] = _Program(graph, launches)
        lt["graph_captures"] += 1
        lt["graph_capture"] += cap.seconds
        return prog

    @torch.no_grad()
    def generate(
        self,
        requests: Sequence[Request],
        on_token: Optional[Callable[[int, int], None]] = None,
    ) -> List[Completion]:
        """Run all requests to completion; slots refill as they free.

        Each call records its spans (``utils/tracing.py``): ``engine.generate``;
        under it ``engine.request`` a request, from the admission forward that
        takes it to its last token; ``engine.admit`` (bucketed) and
        ``engine.admit_chunks`` with their host preparation
        ``engine.admit_prep``; a burst's ``engine.dispatch`` (``slots``, ``steps``;
        ``engine.capture`` at a program's first use), ``engine.wait`` (blocked
        on its tokens) and ``engine.accept`` (taking them in, ``on_token``
        included); ``engine.spec`` a speculative step; ``engine.restart``.
        ``loop_stats`` sums their seconds: ``decode`` is dispatch less capture
        plus the wait, ``decode_wait`` the wait, ``decode_accept`` the accept;
        ``decode_slot_steps`` counts the active slots times the steps of every
        burst or speculative step dispatched."""
        with tracing.span("engine.generate") as gen:
            return self._generate(requests, on_token, gen.id)

    def _generate(self, requests, on_token, gen_id: int) -> List[Completion]:
        S = self.cfg.max_seq_len
        dev = self.device
        pending = deque()
        for r in requests:
            if r.id is None:
                r = dataclasses.replace(r, id=self._next_id)
            self._next_id = max(self._next_id, r.id + 1)
            if len(r.prompt) >= S:
                raise ValueError(f"prompt length {len(r.prompt)} >= max_seq_len {S}")
            if self.spec_tokens and r.temperature > 0:
                raise ValueError("speculative decoding verifies greedily; temperature > 0 "
                                 "requests need spec_tokens=0")
            pending.append(r)

        slot_req: List[Optional[Request]] = [None] * self.slots
        slot_gen: List[List[int]] = [[] for _ in range(self.slots)]
        slot_len = np.zeros(self.slots, np.int64)  # prompt + generated
        cur_tok = np.zeros(self.slots, np.int32)
        temps = np.zeros(self.slots, np.float32)
        active = np.zeros(self.slots, bool)
        # bursts whose tokens have not reached the host yet, oldest first, and
        # each slot's admission count: a recycled slot never takes the tokens
        # of a burst that ran for its previous occupant
        inflight: deque = deque()
        slot_epoch = np.zeros(self.slots, np.int64)
        done: List[Completion] = []
        lt = self.loop_stats = defaultdict(float)
        # requests taken from the queue and not yet in slot_req: a device error
        # during their admission requeues them
        in_admission: List[Request] = []
        resume_prefix: dict = {}  # id -> tokens emitted before a restart
        orig_plen: dict = {}  # id -> the prompt length before a restart
        admitted_ns: dict = {}  # id -> the start of its first admission forward

        def finish(b: int, reason: str):
            r = slot_req[b]
            tracing.record("engine.request", admitted_ns.pop(r.id), time.monotonic_ns(),
                           request=r.id, parent=gen_id)
            done.append(Completion(r.id, len(r.prompt), slot_gen[b], reason))
            slot_req[b] = None
            slot_gen[b] = []
            active[b] = False
            if self.paged:
                self._release_pages(b)

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

        def start(group, toks) -> None:
            """Admit prefilled (slot, request, prompt) rows with their first tokens."""
            for i, (b, r, prompt) in enumerate(group):
                slot_req[b] = r
                slot_gen[b] = []
                slot_len[b] = len(prompt)
                temps[b] = r.temperature
                active[b] = True
                slot_epoch[b] += 1
                accept(b, int(toks[i]))

        def replay(prog: _Program):
            """Replay a captured program; returns CUDA events around it."""
            ev0, ev1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            ev0.record()
            prog.graph.replay()
            ev1.record()
            for k, n in prog.launches.items():
                common.launches[k] += n
            lt["graph_replays"] += 1
            return ev0, ev1

        def dispatch(step_active) -> None:
            """Queue one decode burst for the slots of ``step_active``; continuing
            slots take their input from the newest burst in flight, on the device."""
            n = int(step_active.sum())
            with tracing.span("engine.dispatch", slots=n, steps=self.decode_burst) as sp:
                greedy = not (temps[step_active] > 0).any()
                self._upload(self._tok_in, cur_tok)
                if inflight:  # host tokens lag the bursts in flight
                    newest = inflight[-1]
                    self._upload(self._cont_in, newest.step_active & (slot_epoch == newest.epochs))
                    self._tok_in.copy_(torch.where(self._cont_in, self._burst_out[-1],
                                                   self._tok_in))
                # only now: a first capture's warm-up overwrites _burst_out and _act_in
                captured = lt["graph_capture"]
                prog = self._program(greedy)
                captured = lt["graph_capture"] - captured  # kept apart from decode time
                self._upload(self._act_in, step_active)
                self._upload(self._temps_in, temps)
                if prog is None:
                    self._burst(greedy)
                    events = None
                else:
                    events = replay(prog)
                # copied out before the next burst overwrites it (the stream orders both)
                toks, fetched = self._fetch(self._burst_out)
                inflight.append(_InFlight(toks, fetched, events, step_active.copy(),
                                          slot_epoch.copy()))
            lt["decode"] += sp.seconds - captured
            lt["decode_steps"] += self.decode_burst
            lt["decode_slot_steps"] += n * self.decode_burst

        def drain() -> None:
            """Accept the oldest burst in flight, step by step, for the slots it
            ran that still hold the request it ran for (blocks until it is done)."""
            burst = inflight.popleft()
            with tracing.span("engine.wait") as wait:
                toks = burst.wait()  # [burst, slots]
                if burst.events is not None:
                    lt["graph_device"] += 1e-3 * burst.events[0].elapsed_time(burst.events[1])
            lt["decode"] += wait.seconds
            lt["decode_wait"] += wait.seconds
            sa, epochs = burst.step_active, burst.epochs
            with tracing.span("engine.accept", mirror=True) as acc:
                for step in range(toks.shape[0]):
                    for b in range(self.slots):
                        if sa[b] and active[b] and slot_epoch[b] == epochs[b]:
                            accept(b, int(toks[step, b]))
                            lt["decode_tokens"] += 1
                    if not active.any():
                        break  # the rest of the burst is garbage for every slot
            lt["decode_accept"] += acc.seconds

        def spec_step(step_active) -> None:
            """One speculative step: draft (n-gram here, or the draft model's
            chain inside the program), verify, accept."""
            n = int(step_active.sum())
            with tracing.span("engine.spec", slots=n, steps=1) as sp:
                g = self.spec_tokens
                toks = np.zeros((self.slots, g + 1), np.int32)
                toks[:, 0] = cur_tok
                if self.draft is None:
                    for b in range(self.slots):
                        if step_active[b]:
                            toks[b, 1:] = self._draft(list(slot_req[b].prompt) + slot_gen[b], g)
                captured = lt["graph_capture"]
                prog = self._program("spec")
                captured = lt["graph_capture"] - captured
                self._upload(self._spec_in, toks)
                self._upload(self._act_in, step_active)
                if prog is None:
                    self._spec()
                    events = None
                else:
                    events = replay(prog)
                out, fetched = self._fetch(self._spec_out)
                with tracing.span("engine.wait") as wait:
                    if fetched is not None:
                        fetched.synchronize()
                    out = out.numpy()
                    if events is not None:
                        lt["graph_device"] += 1e-3 * events[0].elapsed_time(events[1])
            lt["decode"] += sp.seconds - captured
            lt["decode_wait"] += wait.seconds
            lt["decode_steps"] += 1
            lt["decode_slot_steps"] += n
            toks, greedy, accepted = out[:, : g + 1], out[:, g + 1 : 2 * g + 2], out[:, -1]
            with tracing.span("engine.accept", mirror=True) as acc:
                for b in range(self.slots):
                    if not step_active[b]:
                        continue
                    a = int(accepted[b])
                    self.spec_stats["drafted"] += g
                    self.spec_stats["accepted"] += a
                    emitted = list(toks[b, 1 : 1 + a]) + [greedy[b, a]]
                    # the verify wrote nothing past the capacity: neither is emitted
                    for tok in emitted[: max(0, S - int(slot_len[b]))]:
                        if active[b]:
                            accept(b, int(tok))
                            lt["decode_tokens"] += 1
            lt["decode_accept"] += acc.seconds

        def run_loop() -> None:
            while pending or active.any() or inflight:
                admit, longs = [], []
                for b in range(self.slots):
                    if not active[b] and pending:
                        # paged: a request is admitted only if the pool can back its
                        # whole prompt and one more; else it waits for pages
                        if self.paged and not self._pages_for(b, len(pending[0].prompt) + 1):
                            lt["admission_waits"] += 1
                            break
                        r = pending.popleft()
                        in_admission.append(r)
                        (admit if len(r.prompt) <= self.buckets[-1] else longs).append(
                            (b, r, list(r.prompt)))
                if self.paged:
                    if pending and not (admit or longs) and not active.any():
                        need = -(-(len(pending[0].prompt) + 1) // self.page_size)
                        raise RuntimeError(
                            f"paged KV pool too small: request needs {need} pages, pool has "
                            f"{len(self._free_pages)} free and nothing running to release more")
                    self._push_table()

                if longs:
                    # every long prompt advances one chunk per forward; a row whose
                    # prompt is exhausted turns inert (length 0, slot out of range);
                    # only a prompt's final chunk is read back and sampled
                    C = self.prefill_chunk
                    n = len(longs)
                    n_chunks = -(-max(len(p) for _, _, p in longs) // C)
                    with tracing.span("engine.admit_chunks", rows=n, chunks=n_chunks) as adm:
                        for _, r, _ in longs:
                            admitted_ns.setdefault(r.id, adm.start_ns)
                        t_adm = [r.temperature for _, r, _ in longs]
                        temps_dev = torch.tensor(t_adm, device=dev)
                        last_tok = [0] * n
                        for ci in range(n_chunks):
                            begin = ci * C
                            with tracing.span("engine.admit_prep", mirror=True):
                                tokens = np.zeros((n, C), np.int64)
                                lens = np.zeros(n, np.int64)
                                slots = np.full(n, self.slots, np.int64)
                                for i, (b, _, prompt) in enumerate(longs):
                                    if begin < len(prompt):
                                        piece = prompt[begin : begin + C]
                                        tokens[i, : len(piece)] = piece
                                        lens[i], slots[i] = len(prompt), b
                            args = (torch.from_numpy(tokens).to(dev),
                                    torch.full((n,), begin, device=dev),
                                    torch.from_numpy(lens).to(dev),
                                    torch.from_numpy(slots).to(dev))
                            resets = torch.full((n,), ci == 0, device=dev)
                            logits, _ = self._steps.prefill_slots_chunk(
                                self.model, *args, self.cache, resets=resets)
                            if self.draft is not None:
                                llama.prefill_slots_chunk(self.draft, *args, self._draft_cache,
                                                          resets=resets)
                            final = [i for i, (_, _, p) in enumerate(longs)
                                     if ci == (len(p) - 1) // C]
                            if final:
                                toks = self._sample(logits, temps_dev, greedy=max(t_adm) <= 0)
                                toks = toks.cpu().numpy()
                                for i in final:
                                    last_tok[i] = int(toks[i])
                            lt["chunks"] += 1
                            lt["chunk_rows"] += n * C
                        start(longs, last_tok)
                    lt["admit_prefill_chunks"] += adm.seconds
                if admit:
                    with tracing.span("engine.admit", rows=len(admit)) as adm:
                        for _, r, _ in admit:
                            admitted_ns.setdefault(r.id, adm.start_ns)
                        with tracing.span("engine.admit_prep", mirror=True):
                            bucket = self._bucket(max(len(p) for _, _, p in admit))
                            tokens = np.zeros((len(admit), bucket), np.int64)
                            for i, (_, _, prompt) in enumerate(admit):
                                tokens[i, : len(prompt)] = prompt
                        adm.attrs["bucket"] = bucket
                        lens = torch.tensor([len(p) for _, _, p in admit], device=dev)
                        slots = torch.tensor([b for b, _, _ in admit], device=dev)
                        t_adm = [r.temperature for _, r, _ in admit]
                        tokens = torch.from_numpy(tokens).to(dev)
                        logits, _ = self._steps.prefill_slots(self.model, tokens, lens, slots,
                                                              self.cache)
                        if self.draft is not None:
                            llama.prefill_slots(self.draft, tokens, lens, slots,
                                                self._draft_cache)
                        toks = self._sample(logits, torch.tensor(t_adm, device=dev),
                                            greedy=max(t_adm) <= 0).cpu().numpy()
                        start(admit, toks)
                    lt["admit_prefill"] += adm.seconds
                    lt["admit_rows"] += len(admit) * bucket
                in_admission.clear()
                if not active.any():
                    if inflight:
                        drain()
                    continue

                if self._fault_hook is not None:
                    self._fault_hook()  # tests inject device errors here
                step_active = active.copy()
                if self.paged:
                    # a slot about to write needs the pages of its next positions; the
                    # host's lengths lag the bursts in flight, so cover theirs too (the
                    # JAX engine covers `pipeline` bursts whether in flight or not).  A
                    # slot the pool cannot serve sits the burst out and resumes later
                    writes = self.spec_tokens + 1 if self.spec_tokens else self.decode_burst
                    ahead = writes * (len(inflight) + 1)
                    for b in range(self.slots):
                        if active[b] and not self._pages_for(b, min(int(slot_len[b]) + ahead, S)):
                            step_active[b] = False
                    sitting = int((step_active != active).sum())
                    if inflight and sitting:
                        # a slot that sits out must resume from its true last token, which
                        # may be in a burst still in flight: take them all in first
                        while inflight:
                            drain()
                        continue
                    lt["deferred_slot_steps"] += sitting * (1 if self.spec_tokens else writes)
                    if not step_active.any():
                        raise RuntimeError("paged KV pool exhausted: every active slot is blocked")
                    self._push_table()
                if self.spec_tokens:
                    spec_step(step_active)
                    continue
                dispatch(step_active)
                while len(inflight) > self.pipeline:  # block only on the oldest
                    drain()

        while True:
            try:
                run_loop()
                break
            except DEVICE_ERRORS:
                if self.restarts >= self.max_restarts:
                    raise
                with tracing.span("engine.restart"):
                    self.restarts += 1
                    lt["restarts"] += 1
                    inflight.clear()
                    # requeue the slots' requests as prompt + emitted so far (the
                    # JAX package's order: the last slot's request first), then the
                    # requests caught in admission
                    requeued = {c.id for c in done}
                    for b in range(self.slots):
                        r = slot_req[b]
                        if r is None:
                            continue
                        requeued.add(r.id)
                        orig_plen.setdefault(r.id, len(r.prompt))
                        resume_prefix[r.id] = resume_prefix.get(r.id, []) + slot_gen[b]
                        remaining = r.max_new_tokens - len(slot_gen[b])
                        if remaining <= 0:
                            tracing.record("engine.request", admitted_ns.pop(r.id),
                                           time.monotonic_ns(), request=r.id, parent=gen_id)
                            done.append(Completion(r.id, orig_plen[r.id], [], "length"))
                        else:
                            pending.appendleft(dataclasses.replace(
                                r, prompt=list(r.prompt) + slot_gen[b], max_new_tokens=remaining))
                        slot_req[b] = None
                        slot_gen[b] = []
                    for r in in_admission:
                        if r.id not in requeued and all(p.id != r.id for p in pending):
                            pending.appendleft(r)
                    in_admission.clear()
                    active[:] = False
                    slot_len[:] = 0
                    cur_tok[:] = 0
                    temps[:] = 0
                    slot_epoch[:] += 1
                    # the graphs hold the old caches' addresses: drop them all,
                    # then capture again at the next burst
                    self._programs.clear()
                    self.cache = None
                    self.cache = self._new_cache()

        if resume_prefix:  # merge the tokens emitted before a restart
            merged = {}
            for c in done:
                if c.id in merged:
                    prev = merged[c.id]
                    merged[c.id] = Completion(c.id, prev.prompt_len, prev.tokens + c.tokens,
                                              c.finish_reason)
                else:
                    merged[c.id] = Completion(c.id, orig_plen.get(c.id, c.prompt_len),
                                              resume_prefix.get(c.id, []) + c.tokens,
                                              c.finish_reason)
            done[:] = merged.values()
        if self.paged:
            self._push_table()  # every page is back: the card's table says so too
        return sorted(done, key=lambda c: c.id)
