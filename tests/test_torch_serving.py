"""The port's serving runtime against the JAX package's: the allocator and
scheduler copies on one random operation sequence, and the ServingEngine
token for token (float32, on the CPU, where the port runs the plain
versions of its kernels)."""

import jax
import numpy as np
import pytest
import torch

from ring_flash_attn_tpu.models import ModelConfig as JaxConfig
from ring_flash_attn_tpu.models.serve import SamplingParams as JaxSampling
from ring_flash_attn_tpu.models.serve import ServingEngine as JaxEngine
from ring_flash_attn_tpu.models.transformer import init_params as jax_init
from ring_flash_attn_tpu.serving import page_allocator as jalloc
from ring_flash_attn_tpu.serving.scheduler import DecodeScheduler as JaxSched
from ring_flash_attn_tpu_torch.models import (
    ModelConfig,
    SamplingParams,
    ServingEngine,
    params_from_jax,
)
from ring_flash_attn_tpu_torch.serving import page_allocator as talloc
from ring_flash_attn_tpu_torch.serving.scheduler import DecodeScheduler

CFG_KW = dict(vocab=61, dim=32, layers=2, heads=4, kv_heads=2, head_dim=16,
              mlp_dim=64, dtype="float32")  # tests/test_serve_model.py's


def _call(obj, name, *args):
    """(result, None) or (None, error type name)."""
    try:
        return getattr(obj, name)(*args), None
    except (talloc.PageAllocatorError, jalloc.PageAllocatorError) as e:
        return None, type(e).__name__


@pytest.mark.parametrize("impl", ["native", "python"])
def test_allocator_copy_matches_jax(impl):
    """One random sequence of alloc, prefix alloc, append, fork, tail COW
    and free, applied to the JAX allocator and the port's copy."""
    mk = {"native": (jalloc.NativePageAllocator, talloc.NativePageAllocator),
          "python": (jalloc.PyPageAllocator, talloc.PyPageAllocator)}[impl]
    ja, ta = mk[0](48, 8), mk[1](48, 8)
    rng = np.random.default_rng(0)
    live = []
    for _ in range(600):
        op = int(rng.integers(0, 6))
        if op == 0 or not live:
            call = ("alloc_seq", int(rng.integers(0, 40)))
        elif op == 1:
            call = ("append_token", int(rng.choice(live)))
        elif op == 2:
            call = ("fork_seq", int(rng.choice(live)))
        elif op == 3:
            call = ("cow_tail", int(rng.choice(live)))
        elif op == 4:
            sid = int(rng.choice(live))
            pref = int(rng.integers(0, ja.seq_len(sid) + 1))
            call = ("alloc_prefix_seq", sid, pref,
                    pref + int(rng.integers(0, 20)))
        else:
            sid = live.pop(int(rng.integers(0, len(live))))
            call = ("free_seq", sid)
        (rj, ej), (rt, et) = _call(ja, *call), _call(ta, *call)
        assert rj == rt and (ej is None) == (et is None), (call, rj, rt)
        if call[0] in ("alloc_seq", "fork_seq", "alloc_prefix_seq") and rj is not None:
            live.append(rj)
        assert ja.free_pages == ta.free_pages
        for sid in live:
            assert ja.seq_len(sid) == ta.seq_len(sid)
            assert np.array_equal(ja.block_table(sid), ta.block_table(sid))


def _plan_key(plan):
    return ([r.req_id for r in plan.admitted],
            [(r.req_id, r.lane, r.generated, r.shared_len)
             for r in plan.running],
            [c.tolist() for c in plan.cow], plan.block_tables.tolist(),
            plan.seq_lens.tolist(), [r.req_id for r in plan.finished])


def _both(fj, ft):
    """Run one operation on both sides: equal results or equal errors."""
    res = []
    for f in (fj, ft):
        try:
            res.append(f())
        except (talloc.PageAllocatorError, jalloc.PageAllocatorError) as e:
            res.append(type(e).__name__)
    assert res[0] == res[1], res
    return res[0]


def test_scheduler_copy_matches_jax():
    """One random sequence of submit (some with prefix_of), commit, fork
    and begin_step on both schedulers: identical plans every step."""
    js = JaxSched(jalloc.PyPageAllocator(40, 8), 6, 3, reserve=1)
    ts = DecodeScheduler(talloc.PyPageAllocator(40, 8), 6, 3, reserve=1)
    rng = np.random.default_rng(1)
    next_id = 0
    for _ in range(150):
        op = int(rng.integers(0, 4))
        running = [r.req_id for r in js.lanes if r is not None and not r.done]
        if op == 0:
            plen = int(rng.integers(1, 30))
            src = (int(rng.choice(list(js._requests)))
                   if js._requests and rng.random() < 0.3 else None)
            pl = 0 if src is None else min(plen, js._requests[src].prompt_len,
                                           int(rng.integers(0, 20)))
            mnt = int(rng.integers(1, 6))
            for s in (js, ts):
                s.submit(next_id, plen, mnt, prefix_of=src, prefix_len=pl)
            next_id += 1
        elif op == 1 and running:
            rid = int(rng.choice(running))
            done = bool(rng.random() < 0.2)
            _both(lambda: js.commit(rid, done=done),
                  lambda: ts.commit(rid, done=done))
        elif op == 2 and running and None in js.lanes:
            rid = int(rng.choice(running))
            _both(lambda: js.fork(rid, next_id).lane,
                  lambda: ts.fork(rid, next_id).lane)
            next_id += 1
        else:
            assert _plan_key(js.begin_step()) == _plan_key(ts.begin_step())
        assert js.idle == ts.idle


@pytest.fixture(scope="module")
def models():
    jparams = jax_init(jax.random.PRNGKey(0), JaxConfig(**CFG_KW))
    tmodel = params_from_jax(jax.tree.map(np.asarray, jparams),
                             ModelConfig(**CFG_KW), device="cpu")
    return jparams, tmodel


def test_serving_engine_matches_jax_token_for_token(models):
    """Greedy requests, one seeded sampled request, a prefix-cached
    admission, a fork that takes the last free lane and two requests that
    queue behind it: the port's engine produces exactly the JAX engine's
    tokens."""
    jparams, tmodel = models
    rng = np.random.default_rng(3)
    common = rng.integers(0, 61, size=19).astype(np.int32)
    prompts = {
        0: np.concatenate([common, rng.integers(0, 61, 3)]).astype(np.int32),
        1: rng.integers(0, 61, size=11).astype(np.int32),
        2: np.concatenate([common, rng.integers(0, 61, 7)]).astype(np.int32),
        3: rng.integers(0, 61, size=30).astype(np.int32),
        4: rng.integers(0, 61, size=5).astype(np.int32),
    }
    new = {0: 6, 1: 3, 2: 4, 3: 2, 4: 5}
    sampled = dict(temperature=1.3, top_k=7, top_p=0.9, seed=123)
    outs = []
    for eng, sp_cls in (
        (JaxEngine(jparams, JaxConfig(**CFG_KW), num_pages=24, page_size=8,
                   pages_per_seq=6, max_batch=4, reserve=1), JaxSampling),
        (ServingEngine(tmodel, num_pages=24, page_size=8, pages_per_seq=6,
                       max_batch=4, reserve=1, device="cpu"),
         SamplingParams),
    ):
        for rid in (0, 1, 2):
            eng.submit(rid, prompts[rid], new[rid],
                       prefix_of=0 if rid == 2 else None,
                       sampling=sp_cls(**sampled) if rid == 1 else None)
        eng.step()  # admits 0, 1, 2 (2 shares 0's first two pages)
        eng.step()
        assert eng.sched._requests[2].shared_len == 16
        alt = (eng.outputs[0][-1] + 1) % 61
        eng.fork(0, 9, next_token=alt, max_new_tokens=6)  # the 4th lane
        for rid in (3, 4):  # both queue until lanes free up
            eng.submit(rid, prompts[rid], new[rid])
        outs.append(eng.run(max_steps=80))
    assert outs[0] == outs[1]
    assert sorted(outs[1]) == [0, 1, 2, 3, 4, 9]


def test_serving_engine_needs_cuda_unless_told_cpu(models):
    _, tmodel = models
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ServingEngine(tmodel, num_pages=8, page_size=8, pages_per_seq=2,
                      max_batch=1)
