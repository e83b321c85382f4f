"""Continuous-batching model serving over the paged KV cache.

The port of ``ring_flash_attn_tpu/models/serve.py``'s default path:

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

Attention runs through kernel B1 (prefill) and kernel B5 (decode) for
CUDA tensors; ``backend="plain"`` runs their plain versions instead.
Chunked prefill, tensor parallelism (``mesh``) and speculative decoding
are not ported yet and raise.
"""

import dataclasses

import numpy as np
import torch

from ..config import check_backend, resolve_device
from ..ops import paged
from ..ops.flash import flash_attention
from ..ops.mask import MaskArgs
from ..serving import PageAllocator
from ..serving.scheduler import DecodeScheduler
from .norm import rmsnorm
from .transformer import _mlp, _proj_qkv, _rope

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


def _rope_batch(x, positions, theta):
    """x (B, H, 1, D), positions (B,) int — per-lane decode positions."""
    return _rope(x, positions[:, None, None], theta)


def _head(model, x, last_idx):
    if last_idx is not None:
        x = x[:, last_idx:last_idx + 1]
    x = rmsnorm(x, model.final_norm)
    return (x @ model.lm_head).float()


@torch.no_grad()
def _prefill_fn(model, tokens, last_idx=None, backend=None):
    """Dense causal forward over ONE padded prompt (1, Sp). Returns
    (logits, ks, vs: per-layer (1, Hkv, Sp, hd)).

    last_idx (int or None): a prefill only samples from ONE position (the
    prompt's last real token), so when given, x is sliced to that row
    before the lm_head and logits come back (1, 1, vocab). None returns
    all positions."""
    cfg = model.cfg
    b, s = tokens.shape
    positions = torch.arange(s, device=tokens.device)
    scale = cfg.head_dim**-0.5
    x = model.embed[tokens]
    ks, vs = [], []
    for layer in model.layers:
        xn = rmsnorm(x, layer.attn_norm)
        q, k, v = _proj_qkv(cfg, layer, xn, b, s)
        q = _rope(q, positions, cfg.rope_theta)
        k = _rope(k, positions, cfg.rope_theta)
        out, _ = flash_attention(q, k, v, scale, MaskArgs(causal=True),
                                 backend=backend)
        x = x + out.transpose(1, 2).reshape(b, s, -1) @ layer.wo
        x = _mlp(x, layer)
        ks.append(k)
        vs.append(v)
    return _head(model, x, last_idx), ks, vs


@torch.no_grad()
def _prefix_prefill_fn(model, tokens, prefix_ks, prefix_vs, last_idx=None,
                       backend=None):
    """Suffix-only prefill: dense causal forward over the padded SUFFIX
    (1, S) of a prompt whose first P tokens' K/V are already cached
    (prefix_ks/vs: per-layer (1, Hkv, P, D) gathered from shared pages).
    Suffix queries attend [prefix ++ suffix] with a causal offset of P.
    Returns (logits, suffix ks, suffix vs) as ``_prefill_fn`` does."""
    cfg = model.cfg
    b, s = tokens.shape
    p_len = prefix_ks[0].shape[2]
    positions = p_len + torch.arange(s, device=tokens.device)
    scale = cfg.head_dim**-0.5
    x = model.embed[tokens]
    ks, vs = [], []
    for layer, pk, pv in zip(model.layers, prefix_ks, prefix_vs):
        xn = rmsnorm(x, layer.attn_norm)
        q, k, v = _proj_qkv(cfg, layer, xn, b, s)
        q = _rope(q, positions, cfg.rope_theta)
        k = _rope(k, positions, cfg.rope_theta)
        k_all = torch.cat([pk.to(k.dtype), k], dim=2)
        v_all = torch.cat([pv.to(v.dtype), v], dim=2)
        out, _ = flash_attention(q, k_all, v_all, scale,
                                 MaskArgs(causal=True, offset=p_len),
                                 backend=backend)
        x = x + out.transpose(1, 2).reshape(b, s, -1) @ layer.wo
        x = _mlp(x, layer)
        ks.append(k)
        vs.append(v)
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
def _decode_body(model, tokens, live, caches, backend=None):
    """One decode step over all lanes. tokens (B,) int pending tokens; live
    (B,) bool; caches: per-layer PagedKVCache whose seq_lens are the
    REWOUND lengths (pending token not yet counted). Returns (logits
    (B, vocab) f32, caches with the pending token's K/V appended IN PLACE)."""
    cfg = model.cfg
    b = tokens.shape[0]
    scale = cfg.head_dim**-0.5
    positions = caches[0].seq_lens  # (B,) = pending token's position
    x = model.embed[tokens][:, None]  # (B, 1, d)
    new_caches = []
    for layer, cache in zip(model.layers, caches):
        xn = rmsnorm(x, layer.attn_norm)
        q, k, v = _proj_qkv(cfg, layer, xn, b, 1)
        q = _rope_batch(q, positions, cfg.rope_theta)
        k = _rope_batch(k, positions, cfg.rope_theta)
        cache = paged.paged_append(cache, k, v, mask=live)
        out, _ = paged.paged_decode_attention(q, cache, scale,
                                              backend=backend)
        out = out.to(x.dtype).transpose(1, 2).reshape(b, 1, -1)
        x = x + out @ layer.wo
        x = _mlp(x, layer)
        new_caches.append(cache)
    x = rmsnorm(x, model.final_norm)
    return (x[:, 0] @ model.lm_head).float(), new_caches


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
    """

    def __init__(self, model, num_pages, page_size, pages_per_seq, max_batch,
                 reserve=1, backend=None, allocator=None, prefill_chunk=None,
                 mesh=None, speculate_k=None, device="cuda"):
        self.device = resolve_device(device)
        for name, val in (("prefill_chunk", prefill_chunk), ("mesh", mesh),
                          ("speculate_k", speculate_k)):
            if val is not None:
                raise NotImplementedError(
                    f"ServingEngine({name}=...) is not ported yet "
                    "(see ROADMAP.md)")
        if model.device != self.device:
            raise ValueError(f"model lives on {model.device}, engine on "
                             f"{self.device}")
        self.model = model
        self.cfg = cfg = model.cfg
        self.backend = check_backend(backend)
        self.alloc = allocator or PageAllocator(num_pages, page_size)
        self.sched = DecodeScheduler(self.alloc, pages_per_seq, max_batch,
                                     reserve=reserve)
        self.max_batch = max_batch
        self.caches = [
            paged.paged_init(
                cfg.kv_heads, num_pages, page_size, cfg.head_dim,
                np.zeros((max_batch, pages_per_seq), np.int32),
                dtype=cfg.torch_dtype, device=self.device,
            )
            for _ in model.layers
        ]
        self._prompts = {}
        self._pending = {}  # req_id -> next token (int) awaiting decode
        self._sampling = {}  # req_id -> (SamplingParams, np Generator)
        self._eos = {}  # req_id -> frozenset of stop-token ids
        self.outputs = {}
        self.stats = {"steps": 0, "decode_steps": 0, "prefills": 0,
                      "tokens": 0}

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

    @torch.no_grad()
    def step(self):
        """One scheduler step: COW -> decode pending lanes -> prefill
        admissions. Returns the requests that finished this step."""
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
        # zero lanes with nothing to decode so the kernel skips them
        lens = np.where(live, plan.seq_lens - 1, 0)
        tables = self._tensor(plan.block_tables)
        lens_t = self._tensor(lens)
        self.caches = [c._replace(block_tables=tables, seq_lens=lens_t)
                       for c in self.caches]
        if dec:
            self.stats["decode_steps"] += 1
            logits, self.caches = _decode_body(
                self.model, self._tensor(tokens, torch.long),
                self._tensor(live, torch.bool), self.caches,
                backend=self.backend,
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
                    backend=self.backend,
                )
            else:
                n_shared = 0
                logits, ks, vs = _prefill_fn(self.model, padded,
                                             len(suf) - 1,
                                             backend=self.backend)
            _prefill_write_fn(self.caches, ks, vs,
                              self._tensor(table[n_shared:]))
            self._record(r, self._sample(r.req_id,
                                         logits[0, 0].cpu().numpy()))
        return plan.finished

    def run(self, max_steps=10_000):
        steps = 0
        while not self.sched.idle:
            steps += 1
            if steps > max_steps:
                raise RuntimeError("serving loop did not converge")
            self.step()
        return self.outputs
