"""Slot-based continuous decoding for serving (counterpart of
llamole_tpu/models/gllm/continuous.py SlotDecoder).

A fixed pool of decode slots, rows of one KV cache, streams requests:

  * admit  - prefill a request's left-padded prompt into a staged
             [1, bucket] cache and copy it into a free slot's rows of the
             pool in place, with every state row of that slot
  * chunk  - advance every active slot one token a step, each row at its
             own cache offset and rope position (LLM.forward takes a [B]
             cache_index), until a chunk's steps are done, every slot has
             stopped, or a slot can retire while requests wait
  * retire - rows that hit a stop token or their budget free their slot
             at once; the next request takes it without waiting for the
             rest of the pool

Per row, greedy and sampled decoding are generate()'s: the same prefill,
first token and per-token loop (greedy parity with generate() and with
the JAX SlotDecoder: tests/test_torch_continuous.py). A shared prefix
(the chat template's system block) is prefilled once; prompts that start
with it prefill only their suffix over its stored rows.

The host reads one [S] bool tensor a step (which rows have stopped), as
the JAX while_loop's condition stays on the device. An int8 KV cache
(cfg.kv_cache_dtype 'int8') works as in generate(): the staged prefill's
int8 values and scale planes are copied into the slot verbatim, and each
decode step quantizes the row it writes. Every family of the LLM runs
here, sliding-window configs included (a slot's rows keep slot distance
equal to position distance); a shared prefix with sliding windows is
refused, as in the JAX package (the suffix's left padding shifts its
slots but not the prefix's). Speculative drafting stays off here, as in
JAX (a batch-level optimisation), and ContinuousDesignServer refuses a
repetition penalty.
"""

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .model import LLM, check_supported, make_kv_cache, sample_token


def _bucket(n: int, buckets: Sequence[int]) -> int:
    for b in buckets:
        if n <= b:
            return b
    raise ValueError(f"prompt length {n} exceeds the largest bucket "
                     f"{buckets[-1]}")


class SlotDecoder:
    """Fixed-pool continuous decoder over one LLM.

    Host API (one thread; callers serialize):
      submit(prompt_ids) -> request id
      step() -> [(request_id, tokens np[int32], trigger int)]
      drain() -> run steps until every submitted request finished
    """

    def __init__(self, llm: LLM, *, slots: int = 8, cache_len: int = 1024,
                 max_new_tokens: int = 128,
                 eos_ids: Tuple[int, ...] = (), pad_id: int = 0,
                 temperature: float = 0.6, top_p: float = 0.9,
                 top_k: int = 0, do_sample: bool = True,
                 chunk_steps: int = 8,
                 prompt_buckets: Sequence[int] = (64, 128, 256, 512),
                 shared_prefix: Optional[Sequence[int]] = None,
                 seed: int = 0):
        """shared_prefix: token ids most prompts start with. Its KV rows
        prefill once here; admissions that start with it prefill only
        their suffix and copy prefix + suffix into the slot together.
        Other prompts take the full path (same outputs either way)."""
        check_supported(llm.cfg)
        prefix_len = len(shared_prefix) if shared_prefix else 0
        if prefix_len and llm.cfg.sliding_window is not None:
            # suffix left-padding shifts suffix slots but not prefix
            # slots, breaking the slot-distance == position-distance
            # identity the sliding-window mask relies on
            raise ValueError(
                "shared_prefix is not supported with sliding-window "
                "configs (gemma2) — admit full prompts instead")
        if max_new_tokens + max(prompt_buckets) + prefix_len > cache_len:
            raise ValueError(
                f"cache_len={cache_len} cannot hold the largest prompt "
                f"bucket {max(prompt_buckets)} plus max_new_tokens="
                f"{max_new_tokens}"
                + (f" plus shared prefix {prefix_len}" if prefix_len
                   else ""))
        self.llm = llm
        self.slots = int(slots)
        self.cache_len = int(cache_len)
        self.max_new = int(max_new_tokens)
        self.pad_id = int(pad_id)
        self.temperature = float(temperature)
        self.top_p = float(top_p)
        self.top_k = int(top_k)
        self.do_sample = bool(do_sample)
        self.chunk_steps = int(chunk_steps)
        self.buckets = tuple(sorted(prompt_buckets))
        dev = llm.device
        self._generator = torch.Generator(device=dev).manual_seed(seed)
        self._eos = torch.tensor(list(eos_ids) or [-1], device=dev)

        # device state: the pool's cache and one row per slot of each
        # field, written in place
        S, T = self.slots, self.cache_len
        self.cache = make_kv_cache(llm.cfg, S, T, llm.dtype, dev)

        def full(value, dtype, *shape):
            return torch.full((S, *shape), value, dtype=dtype, device=dev)

        self.state = {
            "tok": full(self.pad_id, torch.long),
            "pos": full(0, torch.long),          # rope position
            "widx": full(0, torch.long),         # cache write offset
            "count": full(0, torch.long),        # tokens emitted
            "done": full(True, torch.bool),
            "trigger": full(-1, torch.long),
            "kv_valid": full(False, torch.bool, T),
            "out": full(self.pad_id, torch.long, self.max_new),
        }
        self._rows = torch.arange(S, device=dev)

        # the shared prefix's KV rows, computed once
        self._prefix: List[int] = list(shared_prefix or [])
        self._prefix_cache = None
        if self._prefix:
            self._prefix_cache = self._prefill_prefix()

        # host bookkeeping: a slot is active while it holds a request
        self._next_id = 0
        self._pending: List[Tuple[int, List[int]]] = []
        self._slot_req: List[Optional[int]] = [None] * S
        self._free = list(range(S))
        self._active = np.zeros(S, bool)
        self.chunks_run = 0
        self.steps_run = 0           # pool decode steps, all chunks
        self.prefix_admissions = 0   # admissions on the shared prefix

    # -- device work -----------------------------------------------------
    @torch.no_grad()
    def _prefill_prefix(self):
        p = len(self._prefix)
        dev = self.llm.device
        staged = make_kv_cache(self.llm.cfg, 1, p, self.llm.dtype, dev)
        ids = torch.tensor([self._prefix], device=dev)
        self.llm(input_ids=ids,
                 positions=torch.arange(p, device=dev)[None],
                 kv_cache=staged, cache_index=0,
                 kv_valid=torch.ones((1, p), dtype=torch.bool, device=dev),
                 last_logits_only=True)
        return staged

    @torch.no_grad()
    def _prefill_admit(self, slot: int, tail: List[int], hit: bool) -> None:
        """Prefill `tail` left-padded to its bucket (over the stored prefix
        rows on a prefix hit) into a staged cache, copy it into `slot`'s
        rows of the pool, and seed every state row of the slot."""
        dev = self.llm.device
        L = _bucket(len(tail), self.buckets)
        ids = torch.full((1, L), self.pad_id, dtype=torch.long, device=dev)
        mask = torch.zeros((1, L), dtype=torch.int32, device=dev)
        ids[0, L - len(tail):] = torch.tensor(tail, device=dev)
        mask[0, L - len(tail):] = 1
        positions = (mask.cumsum(-1) - 1).clamp_min(0)
        P = len(self._prefix) if hit else 0
        if hit:
            zeros = make_kv_cache(self.llm.cfg, 1, L, self.llm.dtype, dev)
            staged = [{k: torch.cat([pc[k], z[k]], dim=1) for k in pc}
                      for pc, z in zip(self._prefix_cache, zeros)]
            kvv = torch.cat([torch.ones((1, P), dtype=torch.bool,
                                        device=dev), mask > 0], dim=1)
            positions = positions + P
        else:
            staged = make_kv_cache(self.llm.cfg, 1, L, self.llm.dtype, dev)
            kvv = mask > 0
        logits, _, staged = self.llm(
            input_ids=ids, positions=positions, kv_cache=staged,
            cache_index=P, kv_valid=kvv, last_logits_only=True)
        tok = sample_token(self._generator, logits[:, -1], self.temperature,
                           self.top_p, self.top_k, self.do_sample)
        done = torch.isin(tok, self._eos)
        written = P + L
        for entry, small in zip(self.cache, staged):
            for k in entry:     # k, v (and an int8 cache's scale planes)
                entry[k][slot, :written] = small[k][0]
        st = self.state
        # every row of the slot: a stale kv_valid row of the slot's last
        # occupant would attend silently
        st["kv_valid"][slot] = False
        st["kv_valid"][slot, :written] = kvv[0]
        st["tok"][slot] = torch.where(done, self.pad_id, tok)[0]
        st["pos"][slot] = positions[0, -1] + 1
        st["widx"][slot] = written
        st["count"][slot] = 0
        st["done"][slot] = done[0]
        st["trigger"][slot] = torch.where(done, tok, -1)[0]
        st["out"][slot] = self.pad_id

    @torch.no_grad()
    def _decode_step(self, running: torch.Tensor) -> None:
        """Advance every running row one token (the JAX _chunk_until's
        loop body)."""
        st, rows = self.state, self._rows
        cidx = st["count"].clamp(0, self.max_new - 1)
        st["out"][rows, cidx] = torch.where(running, st["tok"],
                                            st["out"][rows, cidx])
        # a stopped row's offset can reach cache_len: its cache write is
        # dropped (JAX's mode="drop"), its kv_valid index clamped as JAX's
        widx = st["widx"].clamp(0, self.cache_len - 1)
        st["kv_valid"][rows, widx] |= running
        logits, _, _ = self.llm(input_ids=st["tok"][:, None],
                                positions=st["pos"][:, None],
                                kv_cache=self.cache,
                                cache_index=st["widx"],
                                kv_valid=st["kv_valid"])
        nxt = sample_token(self._generator, logits[:, -1], self.temperature,
                           self.top_p, self.top_k, self.do_sample)
        stopped = running & torch.isin(nxt, self._eos)
        emitted = st["count"] + running.long()
        done = st["done"] | stopped | (running & (emitted >= self.max_new))
        st["trigger"] = torch.where(stopped, nxt, st["trigger"])
        nxt = torch.where(done | ~running, self.pad_id, nxt)
        st["tok"] = torch.where(running, nxt, st["tok"])
        st["pos"] = st["pos"] + running.long()
        st["widx"] = st["widx"] + running.long()
        st["count"] = emitted
        st["done"] = done

    def _chunk(self, max_steps: int, stop_on_retire: bool) -> None:
        """Up to max_steps decode steps; stops once no active row runs or,
        with stop_on_retire, once an active row can retire. One [S] read
        of the stop flags a step."""
        active = torch.from_numpy(self._active).to(self.llm.device)
        for _ in range(max_steps):
            done = self.state["done"].cpu().numpy()
            if not (self._active & ~done).any():
                break
            if stop_on_retire and (self._active & done).any():
                break
            self._decode_step(active & ~self.state["done"])
            self.steps_run += 1

    # -- host API ----------------------------------------------------------
    def max_prompt_len(self, prompt_ids: Sequence[int]) -> int:
        """Longest admissible prompt for THIS prompt (a prefix hit gets the
        prefix length on top of the largest suffix bucket)."""
        if self._is_hit(prompt_ids):
            return len(self._prefix) + self.buckets[-1]
        return self.buckets[-1]

    def _is_hit(self, ids: Sequence[int]) -> bool:
        # at least one suffix token must remain for the first sample
        P = len(self._prefix)
        return bool(P) and len(ids) > P and list(ids[:P]) == self._prefix

    def submit(self, prompt_ids: Sequence[int]) -> int:
        """Queue a request; raises ValueError at once for a prompt past
        every bucket, before it can hold a slot."""
        ids = list(prompt_ids)
        if len(ids) > self.max_prompt_len(ids):
            raise ValueError(
                f"prompt length {len(ids)} exceeds the largest bucket "
                f"{self.buckets[-1]}")
        rid = self._next_id
        self._next_id += 1
        self._pending.append((rid, ids))
        return rid

    @property
    def idle(self) -> bool:
        return not self._pending and all(r is None for r in self._slot_req)

    def _admit_pending(self) -> None:
        while self._pending and self._free:
            rid, ids = self._pending.pop(0)
            hit = self._is_hit(ids)
            tail = ids[len(self._prefix):] if hit else ids
            # resolve the bucket before claiming a slot: a raise must not
            # leak the slot out of the free pool
            _bucket(len(tail), self.buckets)
            slot = self._free.pop(0)
            self._prefill_admit(slot, tail, hit)
            self.prefix_admissions += hit
            self._slot_req[slot] = rid
            self._active[slot] = True

    def _retire(self) -> List[Tuple[int, np.ndarray, int]]:
        done = self.state["done"].cpu().numpy()
        finished, fields = [], None
        for slot, rid in enumerate(self._slot_req):
            if rid is None or not done[slot]:
                continue
            if fields is None:   # a second read only when a row retires
                fields = [self.state[k].cpu().numpy()
                          for k in ("out", "count", "trigger")]
            out, counts, trigs = fields
            toks = np.asarray(out[slot, :counts[slot]], np.int32)
            finished.append((rid, toks, int(trigs[slot])))
            self._active[slot] = False
            self._slot_req[slot] = None
            self._free.append(slot)
        return finished

    def step(self, run_to_completion: bool = False) \
            -> List[Tuple[int, np.ndarray, int]]:
        """Admit + one decode chunk + retire. Returns finished requests as
        (request_id, new_tokens, trigger_token_or_-1).

        The chunk stops early once a slot can retire while requests wait
        (the pool is full and only a retirement unblocks the queue), and
        otherwise runs up to chunk_steps -- or, with run_to_completion
        (drain's endgame), until every active slot has finished."""
        self._admit_pending()
        if any(r is not None for r in self._slot_req):
            waiting = bool(self._pending)
            max_steps = (self.max_new if (waiting or run_to_completion)
                         else self.chunk_steps)
            self._chunk(max_steps, stop_on_retire=waiting)
            self.chunks_run += 1
        return self._retire()

    def drain(self) -> Dict[int, Tuple[np.ndarray, int]]:
        results: Dict[int, Tuple[np.ndarray, int]] = {}
        while not self.idle:
            for rid, toks, trig in self.step(run_to_completion=True):
                results[rid] = (toks, trig)
        return results
