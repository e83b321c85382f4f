"""Long-context inference: context-parallel prefill + sequence-sharded
quantized-KV decode.

The port of ``ring_flash_attn_tpu/models/generate.py``. Prefill runs the
llama3 all-gather schedule over the contiguous-sharded prompt and quantizes
each layer's (post-rotary) K/V into an int8 cache shard owned by this rank:
the cache sharding IS the prompt sharding, so nothing moves. Decode feeds
one token at a time with two cache regions:

- the sharded prompt cache (read-only after prefill): each rank computes a
  local partial and the partials LSE-combine across the group
  (``parallel/decode.py``): only O(H * D) values cross between devices per
  step, never the KV;
- a small REPLICATED tail cache for generated tokens: every rank appends
  the same new KV and computes the same tail partial locally, which merges
  into the cross-shard result with the fp32 LSE merge.

Everything here is per-process over a ``torch.distributed`` process group;
``group=None`` with no initialised group is one process holding the whole
prompt (one card). The functions run under ``torch.no_grad()``. The caches
are written in place. ``backend="plain"`` runs the plain versions of the
kernels (B1 in prefill, B4 in decode) on whatever device the model is on.
"""

import torch

from ..ops.merge import merge_partials
from ..ops.quant import make_cache, quant_decode_attention, update_cache
from ..parallel.decode import merge_across_axis
from ..parallel.llama3 import llama3_attention
from ..parallel.mesh import all_reduce, ring_rank, ring_size
from .norm import rmsnorm
from .transformer import ModelConfig, Transformer, _mlp, _proj_qkv, _rope


def _rotary_qkv(cfg, x, layer, positions):
    b, s, _ = x.shape
    q, k, v = _proj_qkv(cfg, layer, rmsnorm(x, layer.attn_norm), b, s)
    return (_rope(q, positions, cfg.rope_theta),
            _rope(k, positions, cfg.rope_theta), v)


@torch.no_grad()
def prefill(model: Transformer, tokens, group=None, backend=None):
    """Per-process prefill over the contiguous-sharded prompt.

    tokens (B, S_local) on the model's device: rank r holds global tokens
    [r * S_local, (r + 1) * S_local). Returns (logits (B, S_local, vocab)
    fp32, caches: one QuantizedKV shard of length S_local per layer)."""
    cfg: ModelConfig = model.cfg
    rank = ring_rank(group)
    b, s_local = tokens.shape
    dev = model.device
    positions = rank * s_local + torch.arange(s_local, device=dev)
    scale = cfg.head_dim**-0.5

    x = model.embed[tokens]
    caches = []
    for layer in model.layers:
        q, k, v = _rotary_qkv(cfg, x, layer, positions)
        out, _ = llama3_attention(q, k, v, scale=scale, causal=True,
                                  group=group, backend=backend)
        x = x + out.transpose(1, 2).reshape(b, s_local, -1) @ layer.wo
        x = _mlp(x, layer)
        caches.append(update_cache(
            make_cache(b, cfg.kv_heads, s_local, cfg.head_dim, device=dev),
            k, v, 0))
    x = rmsnorm(x, model.final_norm)
    return (x @ model.lm_head).float(), caches


@torch.no_grad()
def decode_step(model: Transformer, token, index, n_tail, caches, tails,
                group=None, backend=None):
    """One decode step. token (B,) int at global position ``index``;
    n_tail = generated tokens already in the tail caches (before this one);
    both Python ints. The tail caches are updated in place. Returns
    (logits (B, vocab) fp32, the tail caches)."""
    cfg: ModelConfig = model.cfg
    b = token.shape[0]
    scale = cfg.head_dim**-0.5
    s_local = caches[0].k_q.shape[2]
    positions = torch.full((1,), index, device=model.device)
    x = model.embed[token][:, None]  # (B, 1, d)
    for layer, cache, tail in zip(model.layers, caches, tails):
        q, k, v = _rotary_qkv(cfg, x, layer, positions)
        update_cache(tail, k, v, n_tail)
        # sharded prompt partial + cross-shard combine
        p_out, p_lse = quant_decode_attention(q, cache, s_local, scale,
                                              backend=backend)
        p_out, p_lse = merge_across_axis(p_out, p_lse, group)
        # replicated tail partial, merged locally
        t_out, t_lse = quant_decode_attention(q, tail, n_tail + 1, scale,
                                              backend=backend)
        out, _ = merge_partials(p_out, p_lse, t_out, t_lse)
        out = out.to(x.dtype).transpose(1, 2).reshape(b, 1, -1)
        x = x + out @ layer.wo
        x = _mlp(x, layer)
    x = rmsnorm(x, model.final_norm)
    return (x[:, 0] @ model.lm_head).float(), tails


@torch.no_grad()
def generate(model: Transformer, prompt_local, steps, group=None,
             max_new=None, backend=None):
    """Greedy generation: prefill the sharded prompt, then ``steps`` decode
    steps. Returns (B, steps) int32 generated tokens (replicated), on the
    model's device: the prefill's token followed by ``steps - 1`` decoded
    ones (each step emits its input token, as the JAX scan does). Tokens
    stay on the device: no host sync per step.

    prompt_local (B, S_local): this rank's contiguous prompt shard."""
    cfg: ModelConfig = model.cfg
    max_new = max_new or steps
    w = ring_size(group)
    rank = ring_rank(group)
    dev = model.device
    prompt_local = torch.as_tensor(prompt_local, device=dev).long()
    b, s_local = prompt_local.shape
    prompt_len = s_local * w

    logits, caches = prefill(model, prompt_local, group, backend)
    # the next token comes from the LAST global position (on the last
    # rank); sum-select so that every rank agrees
    last = logits[:, -1] if rank == w - 1 else torch.zeros_like(logits[:, -1])
    del logits
    token = all_reduce(last, "sum", group).argmax(dim=-1)
    tails = [make_cache(b, cfg.kv_heads, max_new, cfg.head_dim, device=dev)
             for _ in model.layers]
    toks = []
    for step in range(steps):
        toks.append(token)
        logits, tails = decode_step(model, token, prompt_len + step, step,
                                    caches, tails, group, backend)
        token = logits.argmax(dim=-1)
    return torch.stack(toks, dim=1).to(torch.int32)
