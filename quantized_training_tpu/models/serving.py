"""Continuous batching for decode serving (slot-based KV cache).

The reference has no serving layer (BASELINE.json lists batched inference
+ continuous batching as a north-star beyond the published numbers); this
is its design:

  - A fixed pool of ``n_slots`` cache slots, each with its own absolute
    position — requests of different lengths decode TOGETHER in one
    jitted step (no head-of-line blocking on the longest request).
  - Admission is per-slot prefill: a length-bucketed jit writes the
    prompt's K/V into the slot rows, so joining a running batch never
    recompiles the decode step.
  - All device code is functional (ServeState pytree in, pytree out) and
    fixed-shape: one compile per decode WINDOW actually reached (the
    attention reads only the first ``window`` cache rows, picked from
    host-tracked slot positions, so short conversations never pay
    ``max_len``-sized attention), one per prefill bucket.
  - INT8 KV quantization is inherited from llama_infer (same
    ``_quant_kv``), so memory per slot matches the batched decoder.

The :class:`Server` wrapper owns slot allocation / eviction / finished
detection host-side; everything device-side lives in the jitted
``_prefill_into_slot`` and ``_decode_step``.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from . import llama, llama_infer
from .llama_infer import KVCache, _quant_kv
from ..quant import qlinear

Array = jax.Array


@partial(
    jax.tree_util.register_dataclass,
    data_fields=["cache", "pos", "active", "last_token"],
    meta_fields=[],
)
@dataclass
class ServeState:
    """Device-side serving state (pytree).

    cache: KVCache over the slot dim ([L, n_slots, max_len, KV, hd])
    pos: [n_slots] int32 — next write position (= tokens held) per slot
    active: [n_slots] bool — slot currently serving a request
    last_token: [n_slots] int32 — last sampled token (decode input)
    """

    cache: KVCache
    pos: Array
    active: Array
    last_token: Array

    @classmethod
    def zeros(cls, cfg: llama.LlamaConfig, n_slots: int, max_len: int):
        return cls(
            KVCache.zeros(cfg, n_slots, max_len),
            jnp.zeros((n_slots,), jnp.int32),
            jnp.zeros((n_slots,), bool),
            jnp.zeros((n_slots,), jnp.int32),
        )


def make_prefill(cfg: llama.LlamaConfig):
    """Jitted (params, state, slot, prompt [1, Tpad], n_valid) -> state.

    Runs the standard prefill forward on the padded prompt, then writes
    the produced K/V rows into the slot and arms it for decode. One
    compile per Tpad bucket.
    """

    @partial(jax.jit, donate_argnums=(1,))
    def prefill(params, state: ServeState, slot, prompt, n_valid):
        Tpad = prompt.shape[1]
        tmp = KVCache.zeros(cfg, 1, Tpad)
        logits, tmp = llama_infer.forward_with_cache(
            params, prompt, tmp, 0, cfg
        )
        # scatter the prompt K/V into the slot (per layer: [1, Tpad,...])
        def write(full, new):
            return jax.lax.dynamic_update_slice(
                full, new, (0, slot, 0, 0, 0)
            )

        cache = KVCache(
            write(state.cache.k, tmp.k),
            write(state.cache.k_scale, tmp.k_scale),
            write(state.cache.v, tmp.v),
            write(state.cache.v_scale, tmp.v_scale),
        )
        # first generated token comes from the last VALID prompt position
        last = jnp.take_along_axis(
            logits[0].astype(jnp.float32), (n_valid - 1)[None, None], axis=0
        )[0]
        tok = jnp.argmax(last, axis=-1).astype(jnp.int32)
        return ServeState(
            cache,
            state.pos.at[slot].set(n_valid),
            state.active.at[slot].set(True),
            state.last_token.at[slot].set(tok),
        )

    return prefill


def make_decode_step(cfg: llama.LlamaConfig, window: int | None = None,
                     n_steps: int = 1):
    """Jitted (params, state) -> (state, tokens).

    One decode token for EVERY slot in one batched forward; inactive
    slots compute masked garbage and are left untouched (their pos and
    last_token don't advance).

    ``window``: attention only reads the first ``window`` cache rows
    (static slice). The Server picks the smallest power-of-two window
    covering the deepest active slot, so decode attention cost scales
    with actual fill instead of ``max_len`` — one compile per window
    bucket actually reached. ``None`` attends over the full cache.

    ``n_steps``: decode CHUNKS — ``n_steps`` tokens per slot in one
    device program (a ``lax.scan`` over the single-step body), returned
    as [n_steps, n_slots]. One host dispatch then costs one
    host<->device round trip per n_steps tokens instead of per token.
    The Server caps the chunk at every active slot's
    remaining budget, so chunking never overruns a request (EOS inside a
    chunk wastes at most n_steps - 1 speculative tokens, which the host
    discards). n_steps == 1 preserves the original [n_slots] return
    shape."""

    @partial(jax.jit, donate_argnums=(1,))
    def step(params, state: ServeState):
        if n_steps == 1:
            return _one(params, state)

        def body(st, _):
            return _one(params, st)

        return jax.lax.scan(body, state, None, length=n_steps)

    def _one(params, state: ServeState):
        n_slots = state.pos.shape[0]
        S = state.cache.max_len
        W = S if window is None else min(window, S)
        H, KV, hd = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
        B = n_slots

        x = params["embed"]["embedding"][state.last_token][:, None]  # [B,1,D]
        cos_f, sin_f = llama.rope_tables(cfg, S)
        # per-slot rope at each slot's own position
        cos = cos_f[state.pos][:, None]  # [B, 1, hd]
        sin = sin_f[state.pos][:, None]

        def rope1(t):  # t: [B, 1, heads, hd]
            half = hd // 2
            t1, t2 = t[..., :half], t[..., half:]
            rot = jnp.concatenate([-t2, t1], axis=-1)
            c = cos[:, :, None, :].astype(t.dtype)
            s = sin[:, :, None, :].astype(t.dtype)
            return t * c + rot * s

        def layer_fn(carry, lp):
            # cache arrays ride the CARRY (aliased in place by XLA) and
            # only the per-slot fresh rows are scattered — scanning the
            # cache through xs/ys would copy it wholesale every step
            # (llama_infer.forward_with_cache has the same design)
            x, kca, ksca, vca, vsca, l = carry
            h = llama.rms_norm(x, lp["attn_norm"]["g"], cfg.rms_norm_eps)
            q = rope1(qlinear(h, lp["q"]["w"]).reshape(B, 1, H, hd))
            k = rope1(qlinear(h, lp["k"]["w"]).reshape(B, 1, KV, hd))
            v = qlinear(h, lp["v"]["w"]).reshape(B, 1, KV, hd)

            k_q, k_s = _quant_kv(k)
            v_q, v_s = _quant_kv(v)
            # per-slot scatter at each slot's own position (vectorized
            # one-row update along the sequence axis)
            rows = jnp.arange(B)
            kca = kca.at[l, rows, state.pos].set(k_q[:, 0])
            ksca = ksca.at[l, rows, state.pos].set(k_s[:, 0].astype(ksca.dtype))
            vca = vca.at[l, rows, state.pos].set(v_q[:, 0])
            vsca = vsca.at[l, rows, state.pos].set(v_s[:, 0].astype(vsca.dtype))

            kc = kca[l, :, :W]
            ksc = ksca[l, :, :W]
            vc = vca[l, :, :W]
            vsc = vsca[l, :, :W]
            k_deq = kc.astype(ksc.dtype) * ksc  # [B, W, KV, hd]
            v_deq = vc.astype(vsc.dtype) * vsc
            G = H // KV
            qg = q.reshape(B, 1, KV, G, hd)
            scores = jnp.einsum(
                "btkgd,bskd->bkgts", qg, k_deq,
                preferred_element_type=jnp.float32,
            ) * (hd ** -0.5)
            # slot b may attend cache positions <= its own pos
            s_ids = jax.lax.broadcasted_iota(jnp.int32, (B, 1, W), 2)
            mask = s_ids <= state.pos[:, None, None]
            scores = jnp.where(mask[:, None, None], scores, -jnp.inf)
            probs = jax.nn.softmax(scores, axis=-1).astype(x.dtype)
            ctx = jnp.einsum("bkgts,bskd->btkgd", probs, v_deq)
            ctx = ctx.reshape(B, 1, H * hd)

            if cfg.bitnet:
                ctx = llama.rms_norm(ctx, lp["o_norm"]["g"], cfg.rms_norm_eps)
            x = x + qlinear(ctx, lp["o"]["w"])
            h = llama.rms_norm(x, lp["mlp_norm"]["g"], cfg.rms_norm_eps)
            act = jax.nn.silu(qlinear(h, lp["gate"]["w"])) * qlinear(h, lp["up"]["w"])
            if cfg.bitnet:
                act = llama.rms_norm(act, lp["down_norm"]["g"], cfg.rms_norm_eps)
            x = x + qlinear(act, lp["down"]["w"])
            return (x, kca, ksca, vca, vsca, l + 1), None

        c = state.cache
        carry0 = (x, c.k, c.k_scale, c.v, c.v_scale, jnp.zeros((), jnp.int32))
        (x, k_all, ks_all, v_all, vs_all, _), _ = jax.lax.scan(
            layer_fn, carry0, params["layers"]
        )
        cache = KVCache(k_all, ks_all, v_all, vs_all)

        x = llama.rms_norm(x, params["final_norm"]["g"], cfg.rms_norm_eps)
        lm_w = (
            params["embed"]["embedding"]
            if cfg.tie_word_embeddings
            else params["lm_head"]["w"]
        )
        logits = qlinear(x, lm_w)[:, 0].astype(jnp.float32)
        tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)

        tok = jnp.where(state.active, tok, state.last_token)
        return (
            ServeState(
                cache,
                jnp.where(state.active, state.pos + 1, state.pos),
                state.active,
                tok,
            ),
            tok,
        )

    return step


class Server:
    """Host-side continuous-batching wrapper.

    Usage:
        srv = Server(params, cfg, n_slots=8, max_len=512)
        rid = srv.add_request([tok, tok, ...], max_new_tokens=64)
        while srv.pending():
            for rid, token in srv.step():   # one decode for all active
                ...
        srv.result(rid)  # full generated token list
    """

    # prefill pad buckets; _start caps the chosen bucket at max_len, so
    # prompts up to max_len - 1 are admissible for any max_len <= 8192
    BUCKETS = (16, 32, 64, 128, 256, 512, 1024, 2048, 4096, 8192)

    def __init__(self, params, cfg: llama.LlamaConfig, n_slots: int, max_len: int,
                 eos_token: int | None = None,
                 window_buckets: tuple[int, ...] | None = None,
                 decode_chunk: int = 16):
        self.params = params
        self.cfg = cfg
        self.n_slots = n_slots
        self.max_len = max_len
        self.eos = eos_token
        # max tokens decoded per device program (see make_decode_step
        # n_steps); actual chunk per step() is the largest power of two
        # <= min(decode_chunk, every active slot's remaining budget,
        # remaining cache rows), so chunking never changes results
        self.decode_chunk = max(1, decode_chunk)
        self.state = ServeState.zeros(cfg, n_slots, max_len)
        self._prefill = make_prefill(cfg)
        # decode attention windows: powers of two from 128 up to max_len
        # (slot positions are tracked HOST-side so picking the window adds
        # no device sync); each window compiles lazily on first use
        if window_buckets is None:
            window_buckets, w = [], 128
            while w < max_len:
                window_buckets.append(w)
                w *= 2
            window_buckets.append(max_len)
        self._windows = tuple(sorted(set(min(w, max_len) for w in window_buckets)))
        assert self._windows[-1] == max_len
        self._decode_fns: dict[tuple[int, int], object] = {}
        self._pos_host: dict[int, int] = {}  # slot -> next write position
        self._free = list(range(n_slots))
        self._slot_req: dict[int, int] = {}
        self._results: dict[int, list[int]] = {}
        self._budget: dict[int, int] = {}
        self._queue: list[tuple[int, list, int]] = []  # (rid, prompt, budget)
        self._pending_emit: list[tuple[int, int]] = []  # prefill tokens
        self._next_rid = 0

    def pending(self) -> bool:
        return bool(self._slot_req or self._queue or self._pending_emit)

    def add_request(self, prompt_tokens, max_new_tokens: int) -> int:
        """Admit a request, or queue it when every slot is busy (queued
        requests are admitted FIFO as slots free up inside step())."""
        n = len(prompt_tokens)
        # max_len - 1: decode writes the slot's next K/V row at pos == n,
        # so a prompt filling the whole cache could never generate
        limit = min(self.BUCKETS[-1], self.max_len - 1)
        if not 0 < n <= limit:
            raise ValueError(
                f"prompt length {n} exceeds limit {limit} "
                f"(min(largest prefill bucket {self.BUCKETS[-1]}, "
                f"max_len {self.max_len} - 1))"
            )
        rid = self._next_rid
        self._next_rid += 1
        # keep FIFO: even if a slot is free (e.g. freed by _finish since
        # the last step), earlier queued requests get it first
        if self._queue or not self._free:
            self._results[rid] = []
            self._queue.append((rid, list(prompt_tokens), max_new_tokens))
            self._admit()
            return rid
        self._start(self._free.pop(), rid, prompt_tokens, max_new_tokens)
        return rid

    def _start(self, slot: int, rid: int, prompt_tokens, max_new_tokens: int):
        n = len(prompt_tokens)
        # cap at max_len: with a non-power-of-two max_len the next bucket
        # can exceed the cache and the prefill scatter would be malformed
        bucket = min(next(b for b in self.BUCKETS if b >= n), self.max_len)
        prompt = np.zeros((1, bucket), np.int32)
        prompt[0, :n] = prompt_tokens
        self.state = self._prefill(
            self.params, self.state, slot, jnp.asarray(prompt),
            jnp.asarray(n, jnp.int32),
        )
        first = int(self.state.last_token[slot])
        self._slot_req[slot] = rid
        self._pos_host[slot] = n
        self._results[rid] = [first]
        self._pending_emit.append((rid, first))  # stream it from step()
        self._budget[rid] = max_new_tokens - 1
        if max_new_tokens <= 1 or first == self.eos:
            self._finish(slot)

    def _admit(self):
        while self._queue and self._free:
            rid, prompt, budget = self._queue.pop(0)
            self._start(self._free.pop(), rid, prompt, budget)

    def _decode_for(self, needed: int, k: int = 1):
        """Smallest compiled decode step whose window covers ``needed``,
        decoding ``k`` tokens per dispatch (compiled lazily per (w, k))."""
        w = next(b for b in self._windows if b >= needed)
        fn = self._decode_fns.get((w, k))
        if fn is None:
            fn = self._decode_fns[(w, k)] = make_decode_step(
                self.cfg, None if w == self.max_len else w, n_steps=k
            )
        return fn

    def _pick_chunk(self) -> int:
        """Largest power-of-two chunk that (a) no active slot's budget
        can end before, (b) fits the cache for the deepest slot, and
        (c) is <= decode_chunk — so chunked output is identical to
        single-stepping, modulo discarded post-EOS speculation."""
        cap = min(
            self.decode_chunk,
            min(self._budget[rid] for rid in self._slot_req.values()),
            max(1, (self.max_len - 1)
                - max(self._pos_host[s] for s in self._slot_req)),
        )
        k = 1
        while k * 2 <= cap:
            k *= 2
        return k

    def step(self):
        """One decode dispatch for all active slots; returns
        [(rid, token)] — including each request's FIRST token (produced
        by its prefill), so a streaming consumer sees all max_new_tokens
        events. A dispatch decodes up to ``decode_chunk`` tokens per slot
        device-side (see make_decode_step)."""
        self._admit()  # fill any slots freed since the last step
        emitted = self._pending_emit
        self._pending_emit = []
        if not self._slot_req:
            return emitted
        k = self._pick_chunk()
        # this dispatch writes rows [pos, pos + k) and attends <= pos+k-1
        needed = max(self._pos_host[s] for s in self._slot_req) + k
        self.state, toks = self._decode_for(needed, k)(self.params, self.state)
        toks = np.asarray(toks)
        if toks.ndim == 1:
            toks = toks[None]
        done: set[int] = set()
        for j in range(k):
            for slot, rid in list(self._slot_req.items()):
                if slot in done:
                    continue
                self._pos_host[slot] += 1
                t = int(toks[j, slot])
                self._results[rid].append(t)
                self._budget[rid] -= 1
                emitted.append((rid, t))
                if (
                    self._budget[rid] <= 0
                    or t == self.eos
                    or self._pos_host[slot] >= self.max_len - 1
                ):
                    # mid-chunk EOS: later rows for this slot are
                    # speculative garbage — drop them. The device-side
                    # pos advanced k regardless, but _finish frees the
                    # slot and the next prefill restarts its position.
                    done.add(slot)
                    self._finish(slot)
        return emitted

    def result(self, rid: int) -> list[int]:
        return self._results[rid]

    def _finish(self, slot: int):
        rid = self._slot_req.pop(slot)
        self._pos_host.pop(slot, None)
        del self._budget[rid]
        self.state = ServeState(
            self.state.cache,
            self.state.pos,
            self.state.active.at[slot].set(False),
            self.state.last_token,
        )
        self._free.append(slot)
