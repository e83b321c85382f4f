"""Continuous-batching model serving over the paged KV cache.

The port of ``ring_flash_attn_tpu/models/serve.py``:

    ServingEngine
      ├─ serving.DecodeScheduler      lane admission / retirement / COW
      ├─ serving.PageAllocator        native C++ refcounted page pool
      ├─ ops.paged.PagedKVCache       one page pool per layer, shared
      │                               block tables (page ids are global)
      └─ models.transformer           the flagship llama-style model

A fixed pool of `max_batch` decode lanes runs ONE decode call per step
whichever lanes are live (dead lanes carry seq_len=0 and hit the kernels'
dead-row path). Prompts pad up to a page multiple; padded positions are
written but never read (reads mask by seq_lens).

Token timeline per request: prefill produces the first sampled token from
the prompt's last logit; each decode step embeds the pending token,
appends its K/V at position seq_len-1 (the scheduler's commit already
counted it), attends over the whole lane, and samples the next token.

Attention runs through kernel B1 (prefill, chunked prefill) and kernel B5
(decode, the speculative verify) for CUDA tensors; ``backend="plain"``
runs their plain versions instead. The engine's options are JAX's:
``prefill_chunk`` (``_chunk_prefill_body``), ``speculate_k``
(``_prompt_lookup`` drafts, ``_spec_verify_body``) and ``mesh``, which
here is the ``torch.distributed`` process group of the tensor-parallel
axis (every rank runs the same engine on its shards).
"""

import dataclasses
from functools import partial

import numpy as np
import torch

from ..config import check_backend, resolve_device
from ..ops import paged
from ..ops.flash import flash_attention
from ..ops.mask import MaskArgs
from ..parallel.mesh import ring_rank, ring_size
from ..serving import PageAllocator
from ..serving.scheduler import DecodeScheduler
from .norm import rmsnorm
from .transformer import _attn_branch, _mlp, shard_params

__all__ = ["ServingEngine", "SamplingParams"]


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Per-request sampling policy (host-side: the device step returns
    full logits rows).

    temperature 0.0 = greedy argmax (the default). Otherwise: logits /
    temperature, then top_k (keep the k highest, 0 = off), then top_p
    nucleus filtering (smallest set of tokens whose probability mass
    reaches top_p), then one categorical draw from a per-request
    deterministic generator — same (seed, request) always yields the same
    continuation."""

    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    seed: int = 0

    def sample(self, logits, rng):
        """logits (vocab,) float np array -> int token id."""
        if self.temperature <= 0.0:
            return int(np.argmax(logits))
        logits = logits.astype(np.float64) / self.temperature
        if self.top_k > 0 and self.top_k < logits.shape[0]:
            kth = np.partition(logits, -self.top_k)[-self.top_k]
            logits = np.where(logits < kth, -np.inf, logits)
        if self.top_p < 1.0:
            order = np.argsort(-logits)
            p = np.exp(logits[order] - np.max(logits))
            p /= p.sum()
            keep_sorted = np.cumsum(p) - p < self.top_p  # first always kept
            keep = np.zeros_like(keep_sorted)
            keep[order] = keep_sorted
            logits = np.where(keep, logits, -np.inf)
        p = np.exp(logits - np.max(logits))
        p /= p.sum()
        return int(rng.choice(logits.shape[0], p=p))


def _layers(model, x, positions, attend, tp_group=False):
    """x through every layer; ``attend(i, q, k, v)`` is layer i's attention
    (``transformer._attn_branch``'s hook). With ``tp_group`` the model
    holds a rank's shards and each branch's partial product is summed over
    the group (``psum_exact`` after wo and after w_down)."""
    for i, layer in enumerate(model.layers):
        x = x + _attn_branch(model.cfg, x, layer, positions,
                             tp_group=tp_group, attend=partial(attend, i))
        x = _mlp(x, layer, tp_group)
    return x


def _head(model, x, last_idx=None):
    if last_idx is not None:
        x = x[:, last_idx:last_idx + 1]
    x = rmsnorm(x, model.final_norm)
    return (x @ model.lm_head).float()


@torch.no_grad()
def _prefill_fn(model, tokens, last_idx=None, backend=None, tp_group=False):
    """Dense causal forward over ONE padded prompt (1, Sp). Returns
    (logits, ks, vs: per-layer (1, Hkv, Sp, hd)).

    last_idx (int or None): a prefill only samples from ONE position (the
    prompt's last real token), so when given, x is sliced to that row
    before the lm_head and logits come back (1, 1, vocab). None returns
    all positions."""
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    scale = model.cfg.head_dim**-0.5
    ks, vs = [], []

    def attend(i, q, k, v):
        ks.append(k)
        vs.append(v)
        return flash_attention(q, k, v, scale, MaskArgs(causal=True),
                               backend=backend)[0]

    x = _layers(model, model.embed[tokens], positions, attend, tp_group)
    return _head(model, x, last_idx), ks, vs


@torch.no_grad()
def _prefix_prefill_fn(model, tokens, prefix_ks, prefix_vs, last_idx=None,
                       backend=None, tp_group=False):
    """Suffix-only prefill: dense causal forward over the padded SUFFIX
    (1, S) of a prompt whose first P tokens' K/V are already cached
    (prefix_ks/vs: per-layer (1, Hkv, P, D) gathered from shared pages).
    Suffix queries attend [prefix ++ suffix] with a causal offset of P.
    Returns (logits, suffix ks, suffix vs) as ``_prefill_fn`` does."""
    p_len = prefix_ks[0].shape[2]
    positions = p_len + torch.arange(tokens.shape[1], device=tokens.device)
    scale = model.cfg.head_dim**-0.5
    mask = MaskArgs(causal=True, offset=p_len)
    ks, vs = [], []

    def attend(i, q, k, v):
        ks.append(k)
        vs.append(v)
        k_all = torch.cat([prefix_ks[i].to(k.dtype), k], dim=2)
        v_all = torch.cat([prefix_vs[i].to(v.dtype), v], dim=2)
        return flash_attention(q, k_all, v_all, scale, mask,
                               backend=backend)[0]

    x = _layers(model, model.embed[tokens], positions, attend, tp_group)
    return _head(model, x, last_idx), ks, vs


@torch.no_grad()
def _prefill_write_fn(caches, ks, vs, lane_table):
    """Scatter one prompt's per-layer K/V into its lane's pages. The page
    pools are updated IN PLACE (where JAX donates them); returns caches."""
    lens = torch.zeros((1,), dtype=torch.int32, device=lane_table.device)
    for cache, k, v in zip(caches, ks, vs):
        one = cache._replace(block_tables=lane_table[None], seq_lens=lens)
        paged.paged_prefill(one, k, v, lens)
    return caches


@torch.no_grad()
def _chunk_prefill_body(model, tokens, p_len, write_table, lane_table,
                        caches, with_logits=True, backend=None,
                        last_idx=None, tp_group=False):
    """One CHUNK of a chunked prefill: forward ``tokens`` (1, C), the
    prompt's tokens at positions [p_len, p_len + C), writing each layer's
    chunk K/V into the lane's pages (in place) and attending over ALL of
    the lane's pages so far (prefix-cached pages included: they are
    earlier entries of the same table).

    p_len: int, the page-aligned chunk start. write_table (C/page_size,)
    int32: the real page ids of this chunk's span, padded with num_pages
    past the prompt's allocation (``paged_prefill`` drops those writes:
    the padded tail of the final chunk). lane_table (pages_per_seq,) int32:
    the lane's whole table. The mask is causal at offset p_len over the
    gathered pages (kernel B1 on the card): kv index j is attended iff
    j <= p_len + row, which covers the written prefix and the chunk's
    causal triangle; the pages past the chunk (garbage) are never read.
    Returns (logits (1, C, vocab), or (1, 1, vocab) for ``last_idx``, or
    None without ``with_logits``; caches)."""
    dev = tokens.device
    positions = p_len + torch.arange(tokens.shape[1], device=dev)
    scale = model.cfg.head_dim**-0.5
    mask = MaskArgs(causal=True, offset=p_len)
    zero = torch.zeros((1,), dtype=torch.int32, device=dev)

    def attend(i, q, k, v):
        cache = caches[i]
        paged.paged_prefill(cache._replace(block_tables=write_table[None],
                                           seq_lens=zero), k, v, zero)
        kd, vd = paged.paged_gather_dense(
            cache._replace(block_tables=lane_table[None]))
        return flash_attention(q, kd, vd, scale, mask, backend=backend)[0]

    x = _layers(model, model.embed[tokens], positions, attend, tp_group)
    if not with_logits:
        return None, caches
    return _head(model, x, last_idx), caches


@torch.no_grad()
def _decode_body(model, tokens, live, caches, backend=None, append=True,
                 tp_group=False):
    """One decode step over all lanes. tokens (B,) int pending tokens; live
    (B,) bool; caches: per-layer PagedKVCache whose seq_lens are the
    REWOUND lengths (pending token not yet counted). Returns (logits
    (B, vocab) f32, caches with the pending token's K/V appended IN PLACE).

    ``append=False`` writes no page and leaves the caches as they are: the
    pending token attends to the lens[b] cached tokens and not to itself.
    The JAX package has the switch so that its read-path benchmarks avoid
    an undonated scatter's copy of the page pool; here the append works in
    place, and no caller in the port sets it (the engine keeps the
    default), so a step with it is not the engine's work.

    ``tp_group``: the model holds this rank's shards of the group
    (``transformer.shard_params``) and the caches its kv_heads / tp heads;
    each rank appends and attends only its heads, the branches' partial
    products are summed over the group, and the logits come out
    replicated."""
    scale = model.cfg.head_dim**-0.5
    positions = caches[0].seq_lens[:, None, None]  # the pending token's
    new = list(caches)

    def attend(i, q, k, v):
        if append:
            new[i] = paged.paged_append(new[i], k, v, mask=live)
        return paged.paged_decode_attention(q, new[i], scale,
                                            backend=backend)[0]

    x = _layers(model, model.embed[tokens][:, None], positions, attend,
                tp_group)
    return _head(model, x)[:, 0], new


@torch.no_grad()
def _spec_verify_body(model, tokens, n_valid, caches, backend=None,
                      append=True, tp_group=False):
    """Speculative-decoding verification: one forward over K candidate
    tokens per lane. tokens (B, K) int: tokens[:, 0] is each lane's
    pending token, tokens[:, 1:] draft proposals; n_valid (B,) int32 in
    [0, K] (0: an idle lane; rows past n_valid are padding); caches'
    seq_lens are the REWOUND lengths. The valid candidates' K/V are
    appended at positions lens .. lens + n_valid - 1 (the caller keeps
    them inside already-allocated pages and rewinds the allocator to the
    accepted count), then attention is the multi-query paged decode
    (``paged_decode_attention`` with ``new_counts=n_valid``: row i attends
    kv index j <= lens[b] + i; kernel B5, in one launch whose grid takes
    row groups where (Hq / Hkv) * K passes the rows one block serves).
    Returns (logits (B, K, vocab) f32, caches with seq_lens advanced by
    n_valid). ``append=False``, as in ``_decode_body``, writes no page and
    the caches come back as they were; the kernel still takes
    ``new_counts=n_valid`` against the lengths not advanced, so row t
    attends only kv j < lens[b] - (n_valid[b] - 1 - t): no candidate, and
    the last n_valid[b] - 1 - t cached tokens are left out too (the JAX
    package's semantics)."""
    b, kk = tokens.shape
    dev = tokens.device
    scale = model.cfg.head_dim**-0.5
    rows = torch.arange(kk, device=dev)[None]
    # (B, 1, K): rotary by lane and row (JAX's _rope_rows)
    positions = (caches[0].seq_lens[:, None] + rows)[:, None]
    valid = rows < n_valid[:, None]
    new = list(caches)

    def attend(i, q, k, v):
        for t in range(kk if append else 0):
            new[i] = paged.paged_append(new[i], k[:, :, t:t + 1],
                                        v[:, :, t:t + 1], mask=valid[:, t])
        return paged.paged_decode_attention(q, new[i], scale,
                                            backend=backend,
                                            new_counts=n_valid)[0]

    x = _layers(model, model.embed[tokens], positions, attend, tp_group)
    return _head(model, x), new


def _prompt_lookup(context, k_draft, max_ngram=3):
    """Prompt-lookup decoding proposals (assisted generation without a
    draft model): find the most recent earlier occurrence of the context's
    final n-gram (longest n first) and propose the tokens that followed
    it. Returns an np array of up to k_draft proposals (may be empty)."""
    ctx = np.asarray(context, np.int32)
    t = len(ctx)
    for n in range(min(max_ngram, t - 1), 0, -1):
        tail = ctx[t - n:]
        # most recent match strictly before the final n-gram itself
        for start in range(t - n - 1, -1, -1):
            if np.array_equal(ctx[start:start + n], tail):
                fol = ctx[start + n:start + n + k_draft]
                if len(fol):
                    return fol
    return np.zeros((0,), np.int32)


def _rank_model(model, group):
    """This rank's shards of the whole ``model`` (``shard_params``) over
    the tensor-parallel ``group``; the model itself at tp = 1."""
    tp = ring_size(group)
    if tp == 1:
        return model
    return shard_params(model, model.cfg, tp_rank=ring_rank(group), tp=tp,
                        device=model.device)


class ServingEngine:
    """Continuous-batching server for the flagship model.

    >>> eng = ServingEngine(model, num_pages=64, page_size=16,
    ...                     pages_per_seq=8, max_batch=4)
    >>> eng.submit(0, prompt_tokens, max_new_tokens=12)
    >>> outputs = eng.run()   # {0: [tok, tok, ...]}

    submit() may be called between step()s — requests queue FIFO and are
    admitted as lanes and pages free up (the "continuous" part).

    ``model`` must already live on ``device`` (default "cuda"; raises
    where CUDA is absent unless device="cpu" is passed). ``backend=None``
    runs the kernels on CUDA tensors; "plain" runs their plain versions.

    prefill_chunk: if set (a page_size multiple), prompts prefill CHUNK
    tokens per engine step through ``_chunk_prefill_body``, so that decode
    steps interleave with long prefills instead of waiting behind them.
    None = dense one-shot prefill (the default; the same tokens either
    way).

    mesh: the ``torch.distributed`` process group of the tensor-parallel
    axis (JAX's mesh with a "tp" axis). Every rank of the group runs this
    engine with the same requests and the whole model, which is cut to
    the rank's shards (``transformer.shard_params``); the page pools hold
    its kv_heads / tp heads, and every step (dense, prefix and
    chunked prefill, decode, verify) sums the branches' partial products
    over the group (``psum_exact`` after wo and w_down). The scheduler,
    the allocator and the sampling run the same on every rank. None: one
    device.

    speculate_k: if > 1, decode steps run SPECULATIVELY for greedy
    (temperature=0) requests: up to k-1 draft tokens proposed by prompt
    lookup (the request's own context, no draft model) are verified
    alongside the pending token in ONE forward (``_spec_verify_body``),
    and the longest agreeing prefix is accepted: the same tokens as plain
    greedy decoding. Sampled requests fall back to one token per step.
    """

    def __init__(self, model, num_pages, page_size, pages_per_seq, max_batch,
                 reserve=1, backend=None, allocator=None, prefill_chunk=None,
                 mesh=None, speculate_k=None, device="cuda"):
        self.device = resolve_device(device)
        if model.device != self.device:
            raise ValueError(f"model lives on {model.device}, engine on "
                             f"{self.device}")
        if prefill_chunk is not None and (
                prefill_chunk <= 0 or prefill_chunk % page_size):
            raise ValueError(f"prefill_chunk={prefill_chunk} must be a "
                             f"positive multiple of page_size={page_size}")
        self.tp_group = False if mesh is None else mesh
        tp = 1 if mesh is None else ring_size(mesh)
        self.model = model if mesh is None else _rank_model(model, mesh)
        self.cfg = cfg = model.cfg
        self.backend = check_backend(backend)
        self.alloc = allocator or PageAllocator(num_pages, page_size)
        self.sched = DecodeScheduler(self.alloc, pages_per_seq, max_batch,
                                     reserve=reserve)
        self.max_batch = max_batch
        self.prefill_chunk = prefill_chunk
        self.speculate_k = speculate_k
        self.num_pages = num_pages
        self.caches = [
            paged.paged_init(
                cfg.kv_heads // tp, num_pages, page_size, cfg.head_dim,
                np.zeros((max_batch, pages_per_seq), np.int32),
                dtype=cfg.torch_dtype, device=self.device,
            )
            for _ in self.model.layers
        ]
        self._prompts = {}
        self._pending = {}  # req_id -> next token (int) awaiting decode
        self._prefilling = {}  # req_id -> chunked-prefill progress dict
        self._sampling = {}  # req_id -> (SamplingParams, np Generator)
        self._eos = {}  # req_id -> frozenset of stop-token ids
        self.outputs = {}
        # tokens counts every recorded token; spec_* count draft proposals
        # and acceptances (tokens a verify step ~= 1 + rate * (k - 1))
        self.stats = {"steps": 0, "decode_steps": 0, "prefills": 0,
                      "prefill_chunks": 0, "tokens": 0,
                      "spec_proposed": 0, "spec_accepted": 0}

    @property
    def spec_acceptance_rate(self):
        p = self.stats["spec_proposed"]
        return self.stats["spec_accepted"] / p if p else 0.0

    def submit(self, req_id, prompt_tokens, max_new_tokens,
               prefix_of=None, sampling=None, eos_token_id=None):
        """Queue a request. prefix_of: a previously submitted request id
        whose prompt shares a common prefix with this one — the shared
        page-aligned prefix is reused read-only (no page copies) and its
        forward pass is SKIPPED at prefill (automatic prefix caching).
        Best-effort: if the source retired before this request is
        admitted, it prefills normally. sampling: a SamplingParams
        (default greedy). eos_token_id: int or set of ints — generating
        any of them finishes the request early (the stop token IS
        recorded in the output); max_new_tokens stays the hard cap."""
        prompt_tokens = np.asarray(prompt_tokens, np.int32).reshape(-1)
        self._prompts[req_id] = prompt_tokens
        self.outputs[req_id] = []
        if eos_token_id is None:
            self._eos[req_id] = frozenset()
        elif isinstance(eos_token_id, (int, np.integer)):
            self._eos[req_id] = frozenset([int(eos_token_id)])
        else:
            self._eos[req_id] = frozenset(int(t) for t in eos_token_id)
        sp = sampling or SamplingParams()
        self._sampling[req_id] = (sp, np.random.default_rng(sp.seed))
        prefix_len = 0
        if prefix_of is not None:
            src = self._prompts[prefix_of]
            n = min(len(src), len(prompt_tokens))
            neq = np.nonzero(src[:n] != prompt_tokens[:n])[0]
            prefix_len = int(neq[0]) if len(neq) else n
            # at least one suffix token must run (it produces the
            # first sampled token's logits)
            prefix_len = min(prefix_len, len(prompt_tokens) - 1)
        self.sched.submit(req_id, len(prompt_tokens), max_new_tokens,
                          prefix_of=prefix_of, prefix_len=prefix_len)

    def fork(self, req_id, new_req_id, next_token=None,
             max_new_tokens=None, sampling=None):
        """Beam-search fork of a RUNNING request: the new request shares
        the source's pages copy-on-write (device page copies surface in
        the next step's plan) and continues decoding from `next_token`
        (default: the source's own pending token). Takes a free lane
        immediately. sampling: SamplingParams for the fork (default: the
        source's policy with a fork-specific generator)."""
        if req_id not in self._pending:
            raise ValueError(f"can only fork a decoding request, not {req_id}")
        r = self.sched.fork(req_id, new_req_id,
                            max_new_tokens=max_new_tokens)
        self._prompts[new_req_id] = self._prompts[req_id]
        sp = sampling or self._sampling[req_id][0]
        self._sampling[new_req_id] = (
            sp,
            np.random.default_rng([sp.seed, abs(hash(new_req_id))]),
        )
        self._eos[new_req_id] = self._eos.get(req_id, frozenset())
        # the source's last recorded token IS its pending (not-yet-decoded)
        # one; a diverging fork replaces it with the alternative
        out = list(self.outputs[req_id])
        if next_token is not None:
            out[-1] = int(next_token)
            self._pending[new_req_id] = int(next_token)
        else:
            self._pending[new_req_id] = self._pending[req_id]
        self.outputs[new_req_id] = out
        return r

    def _sample(self, req_id, logits):
        sp, rng = self._sampling[req_id]
        return sp.sample(logits, rng)

    def _record(self, r, tok):
        self.stats["tokens"] += 1
        self.outputs[r.req_id].append(tok)
        done = (r.generated + 1 >= r.max_new_tokens
                or tok in self._eos.get(r.req_id, ()))
        self.sched.commit(r.req_id, done=done)
        if done:
            self._pending.pop(r.req_id, None)
            self._sampling.pop(r.req_id, None)
        else:
            self._pending[r.req_id] = tok

    def _tensor(self, a, dtype=torch.int32):
        return torch.as_tensor(np.asarray(a), device=self.device).to(dtype)

    def _spec_decode(self, dec, plan):
        """One speculative decode step for the pending lanes: propose,
        verify in one forward, accept the longest agreeing prefix."""
        kk = self.speculate_k
        ps = self.caches[0].page_size
        tokens = np.zeros((self.max_batch, kk), np.int32)
        n_valid = np.zeros((self.max_batch,), np.int32)
        for r in dec:
            tokens[r.lane, 0] = self._pending[r.req_id]
            # the pending token is the last element of outputs, so the
            # lookup context is exactly everything decoded so far
            ctx = np.concatenate([
                self._prompts[r.req_id],
                np.asarray(self.outputs[r.req_id], np.int32),
            ])
            sp, _ = self._sampling[r.req_id]
            props = (_prompt_lookup(ctx, kk - 1)
                     if sp.temperature <= 0.0 else np.zeros(0, np.int32))
            # candidate K/V land at positions L-1 .. L-1+n-1; they must
            # stay inside the allocator's already-reserved pages (the
            # padded block-table tail aliases a live page), and the new
            # tokens must fit the request's remaining budget
            length = int(plan.seq_lens[r.lane])  # includes the pending
            max_pages = -(-length // ps) * ps - (length - 1)
            budget = r.max_new_tokens - r.generated
            n = max(1, min(kk, 1 + len(props), max_pages, budget))
            tokens[r.lane, 1:n] = props[:n - 1]
            n_valid[r.lane] = n
        logits, self.caches = _spec_verify_body(
            self.model, self._tensor(tokens, torch.long),
            self._tensor(n_valid), self.caches, backend=self.backend,
            tp_group=self.tp_group,
        )
        logits = logits.cpu().numpy()
        for r in dec:
            n = int(n_valid[r.lane])
            accepted = []
            for i in range(n):
                g = self._sample(r.req_id, logits[r.lane, i])
                accepted.append(g)
                # row i+1's context is valid only if draft i+1 matched
                if i + 1 < n and tokens[r.lane, i + 1] != g:
                    break
            self.stats["spec_proposed"] += n - 1
            self.stats["spec_accepted"] += len(accepted) - 1
            for tok in accepted:
                if r.done:
                    break  # capacity truncation mid-acceptance
                self._record(r, tok)

    @torch.no_grad()
    def step(self):
        """One scheduler step: COW -> decode pending lanes -> prefill
        admissions -> one chunk of each chunked prefill. Returns the
        requests that finished this step."""
        plan = self.sched.begin_step()
        self.stats["steps"] += 1
        if len(plan.cow[0]):
            for c in self.caches:
                paged.copy_pages(c, plan.cow[0], plan.cow[1])

        # decode every lane with a pending token (plan.seq_lens already
        # counts it — rewind so paged_append writes it at lens-1)
        dec = [r for r in plan.running if r.req_id in self._pending]
        live = np.zeros((self.max_batch,), bool)
        tokens = np.zeros((self.max_batch,), np.int32)
        for r in dec:
            live[r.lane] = True
            tokens[r.lane] = self._pending[r.req_id]
        # zero lanes with nothing to decode (dead, or mid-chunked-prefill)
        # so the kernel skips them
        lens = np.where(live, plan.seq_lens - 1, 0)
        tables = self._tensor(plan.block_tables)
        lens_t = self._tensor(lens)
        self.caches = [c._replace(block_tables=tables, seq_lens=lens_t)
                       for c in self.caches]
        if dec:
            self.stats["decode_steps"] += 1
        if dec and self.speculate_k and self.speculate_k > 1:
            self._spec_decode(dec, plan)
        elif dec:
            logits, self.caches = _decode_body(
                self.model, self._tensor(tokens, torch.long),
                self._tensor(live, torch.bool), self.caches,
                backend=self.backend, tp_group=self.tp_group,
            )
            logits = logits.cpu().numpy()
            for r in dec:
                self._record(r, self._sample(r.req_id, logits[r.lane]))

        # prefill newly admitted prompts (their first token samples from
        # the prompt's last logit; its K/V appends on the next step)
        ps = self.caches[0].page_size
        for r in plan.admitted:
            self.stats["prefills"] += 1
            toks = self._prompts[r.req_id]
            table = plan.block_tables[r.lane]
            p_shared = r.shared_len  # page-aligned, set at admission
            suf = toks[p_shared:]
            if self.prefill_chunk is not None:
                # chunked: queue the suffix; chunks advance below, one per
                # step, interleaved with other lanes' decodes. Prefix-
                # cached pages need no gather: they are earlier entries of
                # the same lane table the chunk attention reads.
                self._prefilling[r.req_id] = {
                    "req": r, "p0": p_shared, "next": 0, "plen": len(toks),
                    "tokens": np.pad(suf, (0, -len(suf) % self.prefill_chunk)),
                    "src": r.prefix_of if p_shared else None,
                }
                continue
            padded = self._tensor(np.pad(suf, (0, -len(suf) % ps))[None],
                                  torch.long)
            if p_shared:
                # prefix caching: gather the shared pages' K/V read-only
                # and forward only the suffix
                n_shared = p_shared // ps
                view = self._tensor(table[None, :n_shared])
                pks, pvs = [], []
                for cache in self.caches:
                    k_pre, v_pre = paged.paged_gather_dense(
                        cache._replace(block_tables=view))
                    pks.append(k_pre)
                    pvs.append(v_pre)
                logits, ks, vs = _prefix_prefill_fn(
                    self.model, padded, pks, pvs, len(suf) - 1,
                    backend=self.backend, tp_group=self.tp_group,
                )
            else:
                n_shared = 0
                logits, ks, vs = _prefill_fn(self.model, padded,
                                             len(suf) - 1,
                                             backend=self.backend,
                                             tp_group=self.tp_group)
            _prefill_write_fn(self.caches, ks, vs,
                              self._tensor(table[n_shared:]))
            self._record(r, self._sample(r.req_id,
                                         logits[0, 0].cpu().numpy()))

        # advance chunked prefills: one chunk per request per step. A
        # request that shares a prefix with one still prefilling waits
        # until the source's chunks have written the shared pages (JAX's
        # engine reads them unwritten here: ROADMAP C16)
        for req_id in list(self._prefilling):
            st = self._prefilling[req_id]
            src = self._prefilling.get(st["src"])
            if src is not None and (src["p0"] + src["next"]
                                    * self.prefill_chunk < st["p0"]):
                continue
            self.stats["prefill_chunks"] += 1
            self._prefill_chunk(req_id)
        return plan.finished

    def _prefill_chunk(self, req_id):
        """Run the next chunk of a chunked prefill; the last one samples
        the request's first token."""
        st = self._prefilling[req_id]
        r, c, j = st["req"], self.prefill_chunk, st["next"]
        ps = self.caches[0].page_size
        p_len = st["p0"] + j * c
        last = (j + 1) * c >= len(st["tokens"])
        # real page ids for this chunk's span; pad past the prompt's
        # allocation with num_pages (paged_prefill drops those writes)
        pages = self.alloc.block_table(r.seq)
        i0 = p_len // ps
        wt = np.full((c // ps,), self.num_pages, np.int32)
        avail = pages[i0:i0 + c // ps]
        wt[:len(avail)] = avail
        lane_table = np.zeros((self.caches[0].block_tables.shape[1],),
                              np.int32)
        lane_table[:len(pages)] = pages
        idx = (st["plen"] - st["p0"] - 1) - j * c
        logits, self.caches = _chunk_prefill_body(
            self.model,
            self._tensor(st["tokens"][None, j * c:(j + 1) * c], torch.long),
            p_len, self._tensor(wt), self._tensor(lane_table), self.caches,
            with_logits=last, backend=self.backend,
            last_idx=idx if last else None, tp_group=self.tp_group,
        )
        st["next"] += 1
        if last:
            del self._prefilling[req_id]
            self._record(r, self._sample(req_id, logits[0, 0].cpu().numpy()))

    def run(self, max_steps=10_000):
        steps = 0
        while not self.sched.idle:
            steps += 1
            if steps > max_steps:
                raise RuntimeError("serving loop did not converge")
            self.step()
        return self.outputs
