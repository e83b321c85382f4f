"""The port's ServingEngine options against the JAX package's, token for
token on the same numpy weights (float32, on the CPU, where the port runs
the plain versions of its kernels): chunked prefill
(tests/test_serve_model.py), speculative decoding (tests/test_serve_spec.py)
and tensor-parallel serving (tests/test_serve_tp.py: the JAX side under
shard_map or on one device, the port's over gloo in spawned processes,
tests/torch_dist_workers.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ring_flash_attn_tpu.models import ModelConfig as JaxConfig
from ring_flash_attn_tpu.models import serve as jserve
from ring_flash_attn_tpu.models.transformer import init_params as jax_init
from ring_flash_attn_tpu.ops import paged as jpaged
from ring_flash_attn_tpu_torch.models import (ModelConfig, SamplingParams,
                                              ServingEngine, params_from_jax)
from ring_flash_attn_tpu_torch.models import serve as tserve
from ring_flash_attn_tpu_torch.ops import paged as tpaged

from torch_dist_workers import run_ranks

CFG_KW = dict(vocab=61, dim=32, layers=2, heads=4, kv_heads=2, head_dim=16,
              mlp_dim=64, dtype="float32")  # tests/test_serve_model.py's
TP_KW = dict(CFG_KW, kv_heads=4)  # tests/test_serve_tp.py's


@pytest.fixture(scope="module")
def models():
    jparams = jax_init(jax.random.PRNGKey(0), JaxConfig(**CFG_KW))
    tmodel = params_from_jax(jax.tree.map(np.asarray, jparams),
                             ModelConfig(**CFG_KW), device="cpu")
    return jparams, tmodel


def _engines(models, **kw):
    """(JAX engine, port engine) on the same weights and options."""
    jparams, tmodel = models
    return (jserve.ServingEngine(jparams, JaxConfig(**CFG_KW), **kw),
            ServingEngine(tmodel, device="cpu", **kw))


def _serve_both(models, prompts, news, prefix_of=None, sampling=None,
                **kw):
    """Each engine's outputs and step count on the same requests."""
    res = []
    for eng, sp_cls in zip(_engines(models, **kw),
                           (jserve.SamplingParams, SamplingParams)):
        for rid, p in prompts.items():
            sp = (sampling or {}).get(rid)
            eng.submit(rid, p, news[rid],
                       prefix_of=(prefix_of or {}).get(rid),
                       sampling=sp_cls(**sp) if sp else None)
        steps = 0
        while not eng.sched.idle:
            steps += 1
            assert steps <= 200
            eng.step()
        res.append((eng.outputs, steps, eng.stats))
    return res


def _prompts(seed, lengths):
    rng = np.random.default_rng(seed)
    return {rid: rng.integers(0, 61, size=n).astype(np.int32)
            for rid, n in enumerate(lengths)}


# ---- chunked prefill ----


def test_chunked_prefill_matches_jax_and_dense(models):
    """Prompts below, at and above the chunk, a tight pool with lane
    turnover: the port's chunked engine gives the JAX chunked engine's
    tokens and the port's dense engine's, with JAX's chunk count."""
    prompts = _prompts(23, [11, 19, 5, 30, 16])
    news = {0: 3, 1: 6, 2: 4, 3: 2, 4: 3}
    kw = dict(num_pages=24, page_size=8, pages_per_seq=6, max_batch=2,
              reserve=1)
    (jo, js, jst), (to, ts, tst) = _serve_both(models, prompts, news,
                                               prefill_chunk=16, **kw)
    assert to == jo and ts == js
    assert tst["prefill_chunks"] == jst["prefill_chunks"] == 7
    dense = ServingEngine(models[1], device="cpu", **kw)
    for rid, p in prompts.items():
        dense.submit(rid, p, news[rid])
    assert dense.run(max_steps=120) == to


def test_chunked_prefill_interleaves_decode(models):
    """A 40-token prompt prefills in 5 chunks of 8 while the running
    request keeps decoding a token every step."""
    rng = np.random.default_rng(29)
    p0 = rng.integers(0, 61, size=6).astype(np.int32)
    p1 = rng.integers(0, 61, size=40).astype(np.int32)
    outs = []
    for eng in _engines(models, num_pages=40, page_size=8, pages_per_seq=7,
                        max_batch=2, reserve=1, prefill_chunk=8):
        eng.submit(0, p0, 10)
        eng.step()
        eng.submit(1, p1, 2)
        n0 = len(eng.outputs[0])
        for k in (1, 2):
            eng.step()
            assert 1 in eng._prefilling
            assert len(eng.outputs[0]) == n0 + k
        outs.append(eng.run(max_steps=60))
    assert outs[0] == outs[1]


def test_chunked_prefill_with_prefix_cache(models):
    """The chunk walk starts after the shared pages, which are read
    through the same lane table."""
    rng = np.random.default_rng(31)
    common = rng.integers(0, 61, size=19).astype(np.int32)
    prompts = {0: np.concatenate([common, rng.integers(0, 61, 3)]),
               1: np.concatenate([common, rng.integers(0, 61, 7)])}
    (jo, _, jst), (to, _, tst) = _serve_both(
        models, {r: p.astype(np.int32) for r, p in prompts.items()},
        {0: 4, 1: 4}, prefix_of={1: 0}, num_pages=40, page_size=8,
        pages_per_seq=6, max_batch=3, reserve=1, prefill_chunk=8)
    assert to == jo
    # 22 tokens in 3 chunks, then the 10 past the 16 shared ones in 2
    assert tst["prefill_chunks"] == jst["prefill_chunks"] == 3 + 2


def test_chunked_prefix_waits_for_its_source(models):
    """A request admitted with a 56-token prefix of one still prefilling
    in chunks of 8: the port runs its chunks only once the source has
    written the shared pages, so it gets the dense engines' tokens (JAX's
    and the port's). JAX's chunked engine reads the unwritten pages here
    and parts from them (ROADMAP C16)."""
    rng = np.random.default_rng(37)
    common = rng.integers(0, 61, size=58).astype(np.int32)
    prompts = {0: np.concatenate([common, rng.integers(0, 61, 4)]),
               1: np.concatenate([common, rng.integers(0, 61, 5)])}
    prompts = {r: p.astype(np.int32) for r, p in prompts.items()}
    kw = dict(num_pages=40, page_size=8, pages_per_seq=10, max_batch=2,
              reserve=1, prefix_of={1: 0})
    (jd, _, _), (td, _, _) = _serve_both(models, prompts, {0: 6, 1: 6},
                                         **kw)
    (jc, _, _), (tc, _, tst) = _serve_both(models, prompts, {0: 6, 1: 6},
                                           prefill_chunk=8, **kw)
    assert tc == td == jd
    assert jc[1] != jd[1]  # the reference's race, which the port avoids
    assert tst["prefill_chunks"] == 8 + 1


def test_chunk_prefill_body_matches_jax(models):
    """One chunk at a page-aligned offset with a padded write table: the
    logits row and the written pages, against JAX's
    ``_chunk_prefill_body``."""
    jparams, tmodel = models
    rng = np.random.default_rng(5)
    num_pages, ps, pps, c = 12, 8, 6, 16
    kp = rng.standard_normal((num_pages, 2, ps, 16)).astype(np.float32)
    vp = rng.standard_normal((num_pages, 2, ps, 16)).astype(np.float32)
    lane = np.asarray([7, 2, 9, 4, 0, 0], np.int32)  # 4 pages allocated
    wt = np.asarray([9, num_pages], np.int32)  # the chunk's second page pads
    toks = rng.integers(0, 61, size=(1, c)).astype(np.int32)
    zero_bt = np.zeros((1, pps), np.int32)
    jc = [jpaged.PagedKVCache(jnp.asarray(kp), jnp.asarray(vp),
                              jnp.asarray(zero_bt), jnp.zeros((1,), jnp.int32))
          for _ in range(2)]
    tc = [tpaged.PagedKVCache(torch.from_numpy(kp.copy()),
                              torch.from_numpy(vp.copy()),
                              torch.from_numpy(zero_bt),
                              torch.zeros((1,), dtype=torch.int32))
          for _ in range(2)]
    jl, jc = jserve._chunk_prefill_body(
        jparams, JaxConfig(**CFG_KW), jnp.asarray(toks), jnp.int32(16),
        jnp.asarray(wt), jnp.asarray(lane), jc, last_idx=jnp.int32(5))
    tl, tc = tserve._chunk_prefill_body(
        tmodel, torch.from_numpy(toks).long(), 16, torch.from_numpy(wt),
        torch.from_numpy(lane), tc, last_idx=5)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-5)
    for a, b in zip(tc, jc):
        np.testing.assert_allclose(a.k_pages.numpy(), np.asarray(b.k_pages),
                                   atol=1e-5)
        np.testing.assert_allclose(a.v_pages.numpy(), np.asarray(b.v_pages),
                                   atol=1e-5)
    none, _ = tserve._chunk_prefill_body(
        tmodel, torch.from_numpy(toks).long(), 16, torch.from_numpy(wt),
        torch.from_numpy(lane), tc, with_logits=False)
    assert none is None


# ---- speculative decoding ----


def test_prompt_lookup_matches_jax():
    """The proposals are exact: the JAX cases and random contexts over a
    small vocabulary (repeats are frequent)."""
    cases = [([1, 7, 8, 9, 4, 5, 7, 8], 3), ([5, 7, 8, 1, 2, 5, 7, 8], 2),
             ([1, 2, 3], 4), ([9, 9], 2), ([4], 3), ([], 2)]
    rng = np.random.default_rng(0)
    cases += [(rng.integers(0, 4, size=int(rng.integers(1, 30))).tolist(),
               int(rng.integers(1, 6))) for _ in range(200)]
    for ctx, k in cases:
        got = tserve._prompt_lookup(ctx, k)
        want = jserve._prompt_lookup(ctx, k)
        assert got.dtype == np.int32 and got.tolist() == want.tolist(), ctx
    assert tserve._prompt_lookup([1, 7, 8, 9, 4, 5, 7, 8], 3).tolist() == [
        9, 4, 5]


SPEC_KW = dict(num_pages=40, page_size=8, pages_per_seq=8, max_batch=2,
               reserve=1)


@pytest.mark.parametrize("k", [4, 10])
def test_spec_matches_jax_repetitive(models, k):
    """Repetitive prompts (the lookup hits often): the port gives JAX's
    tokens, in JAX's step count and acceptance, fewer steps than plain
    decoding; k = 10 takes (Hq / Hkv) * k = 20 rows a kv head, past the
    16 one launch of B5 serves."""
    rng = np.random.default_rng(3)
    unit = rng.integers(0, 61, size=5).astype(np.int32)
    prompts = {0: np.tile(unit, 4),
               1: rng.integers(0, 61, 13).astype(np.int32)}
    news = {0: 10, 1: 6}
    (jo, js, jst), (to, ts, tst) = _serve_both(models, prompts, news,
                                               speculate_k=k, **SPEC_KW)
    assert to == jo and ts == js
    assert {n: tst[n] for n in ("spec_proposed", "spec_accepted")} == {
        n: jst[n] for n in ("spec_proposed", "spec_accepted")}
    plain = ServingEngine(models[1], device="cpu", **SPEC_KW)
    for rid, p in prompts.items():
        plain.submit(rid, p, news[rid])
    assert plain.run() == to
    assert ts < plain.stats["steps"]
    assert 0 < tst["spec_accepted"] <= tst["spec_proposed"]


def test_spec_matches_jax_nonrepetitive(models):
    rng = np.random.default_rng(7)
    prompts = {0: rng.integers(0, 61, 11).astype(np.int32),
               1: rng.integers(0, 61, 24).astype(np.int32)}
    (jo, _, _), (to, _, _) = _serve_both(models, prompts, {0: 7, 1: 4},
                                         speculate_k=5, **SPEC_KW)
    assert to == jo


def test_spec_sampled_lane_falls_back(models):
    """A temperature > 0 lane draws one token a step under speculation:
    the same stream, the same tokens as JAX's engine."""
    rng = np.random.default_rng(11)
    prompts = {0: np.tile(rng.integers(0, 61, 4), 5).astype(np.int32),
               1: rng.integers(0, 61, 9).astype(np.int32)}
    sampling = {1: dict(temperature=1.1, top_k=9, seed=5)}
    (jo, _, _), (to, _, _) = _serve_both(models, prompts, {0: 8, 1: 6},
                                         sampling=sampling, speculate_k=4,
                                         **SPEC_KW)
    assert to == jo


def test_spec_with_fork(models):
    """A copy-on-write fork mid-speculation: both branches as in JAX."""
    rng = np.random.default_rng(13)
    prompt = np.tile(rng.integers(0, 61, 4), 4).astype(np.int32)
    outs = []
    for eng in _engines(models, num_pages=60, page_size=8, pages_per_seq=8,
                        max_batch=3, reserve=1, speculate_k=4):
        eng.submit(0, prompt, 9)
        eng.step()
        eng.step()
        alt = int((eng.outputs[0][-1] + 1) % 61)
        eng.fork(0, 1, next_token=alt, max_new_tokens=9)
        outs.append(eng.run(max_steps=60))
    assert outs[0] == outs[1]


def test_spec_verify_rows_c6(models, monkeypatch):
    """ROADMAP C6 at its first caller: in every verify, a lane with
    candidates has seq_lens >= new_counts (each row's bound seq_lens -
    (new_counts - 1 - t) is >= 1), a lane without any (n_valid 0) has
    seq_lens 0 (the dead-lane path), and no row past a lane's n_valid,
    an idle lane's included, is ever sampled."""
    seen = []
    verify, decode = tserve._spec_verify_body, tpaged.paged_decode_attention

    def recording_decode(q, cache, scale, **kw):
        if kw.get("new_counts") is not None:
            seen.append((cache.seq_lens.clone(), kw["new_counts"].clone()))
        return decode(q, cache, scale, **kw)

    def poisoned_verify(model, tokens, n_valid, caches, **kw):
        logits, caches = verify(model, tokens, n_valid, caches, **kw)
        rows = torch.arange(tokens.shape[1])[None] >= n_valid[:, None]
        return logits.masked_fill(rows[..., None], float("nan")), caches

    monkeypatch.setattr(tpaged, "paged_decode_attention", recording_decode)
    monkeypatch.setattr(tserve, "_spec_verify_body", poisoned_verify)
    eng = ServingEngine(models[1], device="cpu", num_pages=40, page_size=8,
                        pages_per_seq=8, max_batch=3, reserve=1,
                        speculate_k=6)
    sample = eng._sample

    def finite_sample(req_id, logits):
        assert np.all(np.isfinite(logits)), req_id
        return sample(req_id, logits)

    eng._sample = finite_sample
    rng = np.random.default_rng(3)
    unit = rng.integers(0, 61, size=5).astype(np.int32)
    eng.submit(0, np.tile(unit, 4), 12)
    eng.submit(1, rng.integers(0, 61, 9).astype(np.int32), 5)
    eng.run(max_steps=60)  # 2 requests, 3 lanes: one lane stays idle
    assert seen and eng.stats["spec_accepted"] > 0
    for lens, counts in seen:
        live = counts > 0
        assert bool((lens[live] >= counts[live]).all()), (lens, counts)
        assert bool((lens[~live] == 0).all()), (lens, counts)


@pytest.mark.parametrize("tq", [1, 9, 16])
def test_b5_row_groups_equal_one_call(tq):
    """A speculative verify's B5 past 16 rows a kv head (G = 4, Tq rows
    with new_counts: 4, 36 and 64 rows) is one call: on the card one
    launch whose grid takes the row groups of ``row_groups``, each row
    with its own bound; here the plain version over all rows at once,
    against JAX's XLA path (1e-5: the same fp32 formula) and its kernel in
    interpret mode (2e-2: that kernel rounds q * scale and p to bf16,
    2^-9 of logits up to ~5, which lanes of 11 to 48 tokens do not
    average out)."""
    from ring_flash_attn_tpu_torch.ops.quant_decode_cuda import row_groups

    rng = np.random.default_rng(tq)
    b, hq, hkv, d, ps, pps = 4, 8, 2, 64, 8, 6
    num_pages = b * pps
    k, v = (rng.standard_normal((num_pages, hkv, ps, d)).astype(np.float32)
            for _ in range(2))
    tables = rng.permutation(num_pages).reshape(b, pps).astype(np.int32)
    lens = np.asarray([30, 0, 48, 11], np.int32)
    counts = np.asarray([min(tq, 7), 0, tq, 1], np.int32)
    q = rng.standard_normal((b, hq, tq, d)).astype(np.float32)
    cache = tpaged.PagedKVCache(*(torch.from_numpy(x)
                                  for x in (k, v, tables, lens)))
    jcache = jpaged.PagedKVCache(*(jnp.asarray(x)
                                   for x in (k, v, tables, lens)))
    rows = (hq // hkv) * tq
    nrg, per = row_groups(rows, d)
    assert (nrg, per) == ((1, rows) if rows <= 16 else (-(-rows // 16), 16))
    got = tpaged.paged_decode_attention(torch.from_numpy(q), cache, 0.2,
                                        new_counts=torch.from_numpy(counts))
    for backend, tol in (("xla", 1e-5), ("pallas_interpret", 2e-2)):
        want = jpaged.paged_decode_attention(
            jnp.asarray(q), jcache, 0.2, backend=backend,
            new_counts=jnp.asarray(counts))
        for a, r in zip(got, want):
            assert a.shape == r.shape
            np.testing.assert_allclose(a.numpy(), np.asarray(r), rtol=0,
                                       atol=tol, err_msg=backend)


# ---- the read-path switch append=False and paged_init's default tables ----

# float32 on both sides, as the module's other bodies are held
BODY_TOL = 1e-4


def _default_table_caches(seed, b=3, ps=8, pps=4):
    """JAX's and the port's per-layer caches from ``paged_init`` with the
    default contiguous tables (two spare pages past the lanes'), random
    pages, lengths [2 ps - 3, ps, 0] (a dead lane)."""
    rng = np.random.default_rng(seed)
    hkv, d, num_pages = CFG_KW["kv_heads"], CFG_KW["head_dim"], b * pps + 2
    lens = np.asarray([2 * ps - 3, ps, 0], np.int32)
    jc, tc = [], []
    for _ in range(CFG_KW["layers"]):
        j0 = jpaged.paged_init(b, hkv, num_pages, ps, pps, d, jnp.float32)
        t0 = tpaged.paged_init(hkv, num_pages, ps, d, dtype=torch.float32,
                               device="cpu", batch=b, pages_per_seq=pps)
        assert np.array_equal(t0.block_tables.numpy(),
                              np.asarray(j0.block_tables))
        assert not t0.k_pages.any() and not t0.seq_lens.any()
        k, v = (rng.standard_normal(t0.k_pages.shape).astype(np.float32)
                for _ in range(2))
        jc.append(j0._replace(k_pages=jnp.asarray(k), v_pages=jnp.asarray(v),
                              seq_lens=jnp.asarray(lens)))
        tc.append(t0._replace(k_pages=torch.from_numpy(k.copy()),
                              v_pages=torch.from_numpy(v.copy()),
                              seq_lens=torch.from_numpy(lens.copy())))
    return jc, tc


def _same_caches(tc, jc):
    for a, r in zip(tc, jc):
        for x, y in zip(a, r):
            np.testing.assert_allclose(x.numpy(), np.asarray(y), rtol=0,
                                       atol=1e-6)


@pytest.mark.parametrize("append", [False, True])
def test_decode_and_verify_bodies_append_switch_match_jax(models, append):
    """``_decode_body`` and ``_spec_verify_body`` with ``append`` off (no
    page written: the pending token and the candidates do not attend to
    themselves; the caches come back as they were) and on, over caches
    from ``paged_init``'s default tables, against JAX's bodies: logits
    within BODY_TOL, the caches' pages and lengths equal."""
    jparams, tmodel = models
    cfg = JaxConfig(**CFG_KW)
    jc, tc = _default_table_caches(5)
    before = [tuple(x.clone() for x in c) for c in tc]
    tokens, live = np.asarray([5, 9, 0], np.int32), np.asarray(
        [True, True, False])
    jl, jc2 = jserve._decode_body(jparams, cfg, jnp.asarray(tokens),
                                  jnp.asarray(live), jc, append=append)
    tl, tc2 = tserve._decode_body(tmodel, torch.from_numpy(tokens).long(),
                                  torch.from_numpy(live), tc, append=append)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                               atol=BODY_TOL)
    _same_caches(tc2, jc2)
    if not append:
        _same_caches(tc2, [tuple(x.numpy() for x in c) for c in before])

    jc, tc = _default_table_caches(6)
    cand = np.asarray([[5, 9, 17], [3, 3, 0], [0, 0, 0]], np.int32)
    n_valid = np.asarray([3, 2, 0], np.int32)
    jl, jc2 = jserve._spec_verify_body(jparams, cfg, jnp.asarray(cand),
                                       jnp.asarray(n_valid), jc,
                                       append=append)
    tl, tc2 = tserve._spec_verify_body(tmodel, torch.from_numpy(cand).long(),
                                       torch.from_numpy(n_valid), tc,
                                       append=append)
    valid = np.arange(3)[None] < n_valid[:, None]
    np.testing.assert_allclose(tl.numpy()[valid], np.asarray(jl)[valid],
                               rtol=0, atol=BODY_TOL)
    _same_caches(tc2, jc2)


def test_paged_init_default_tables():
    """Without tables ``paged_init`` gives lane b JAX's contiguous pages
    [b pps, (b + 1) pps), as int32 on the device, and refuses a pool too
    small for them or a call without ``batch`` and ``pages_per_seq``;
    given tables are kept as they are."""
    t = tpaged.paged_init(2, 9, 4, 8, device="cpu", batch=2,
                          pages_per_seq=4)
    j = jpaged.paged_init(2, 2, 9, 4, 4, 8)
    assert t.block_tables.dtype == torch.int32
    assert np.array_equal(t.block_tables.numpy(), np.asarray(j.block_tables))
    assert t.seq_lens.tolist() == [0, 0] and t.k_pages.shape == (9, 2, 4, 8)
    with pytest.raises(ValueError, match="need 12 pages"):
        tpaged.paged_init(2, 9, 4, 8, device="cpu", batch=3, pages_per_seq=4)
    with pytest.raises(ValueError, match="batch and pages_per_seq"):
        tpaged.paged_init(2, 9, 4, 8, device="cpu")
    own = tpaged.paged_init(2, 9, 4, 8, [[8, 1], [0, 2]], device="cpu")
    assert own.block_tables.tolist() == [[8, 1], [0, 2]]


# ---- tensor-parallel serving ----

B, PS, PPS = 3, 8, 4


def _tp_caches(seed):
    """JAX's and the port's inputs of a decode step: per-layer random
    pages over a permuted pool, lengths [2 PS - 3, PS, 0] (a dead lane)."""
    rng = np.random.default_rng(seed)
    num_pages = B * PPS
    out = []
    for _ in range(TP_KW["layers"]):
        k, v = (rng.standard_normal((num_pages, 4, PS, 16)).astype(np.float32)
                for _ in range(2))
        bt = rng.permutation(num_pages).reshape(B, PPS).astype(np.int32)
        out.append((k, v, bt, np.asarray([2 * PS - 3, PS, 0], np.int32)))
    return out


def _tp_decode_payload(jparams, np_caches, steps):
    """JAX's single-device ``_decode_body`` chain (each step fed the last
    step's argmax): the port's payload and JAX's results."""
    cfg = JaxConfig(**TP_KW)
    caches = [jpaged.PagedKVCache(*map(jnp.asarray, c)) for c in np_caches]
    tokens = jnp.asarray([5, 9, 0], jnp.int32)
    live = jnp.asarray([True, True, False])
    feed, logits = [], []
    for _ in range(steps):
        feed.append(np.asarray(tokens))
        lg, caches = jserve._decode_body(jparams, cfg, tokens, live, caches)
        logits.append(np.asarray(lg))
        tokens = jnp.argmax(lg, -1).astype(jnp.int32)
    payload = {"caches": np_caches, "feed": np.stack(feed),
               "live": np.asarray(live)}
    return payload, logits, [jax.tree.map(np.asarray, c) for c in caches]


TP_REQUESTS_SEED = 43


def _tp_engine_requests():
    rng = np.random.default_rng(TP_REQUESTS_SEED)
    common = rng.integers(0, 61, size=17).astype(np.int32)
    return [
        (0, rng.integers(0, 61, size=11).astype(np.int32), 4, None),
        (1, np.concatenate([common, rng.integers(0, 61, 4)]).astype(
            np.int32), 3, None),
        (2, np.concatenate([common, rng.integers(0, 61, 6)]).astype(
            np.int32), 3, 1),
        (3, rng.integers(0, 61, size=26).astype(np.int32), 2, None),
    ]


TP_ENGINE_KW = dict(num_pages=32, page_size=8, pages_per_seq=6, max_batch=2,
                    reserve=1, prefill_chunk=16)


@pytest.fixture(scope="module")
def tp_runs():
    """One gloo set at W=2 (the decode chain, the engine with chunked
    prefill and prefix caching, and with speculation) and one at W=4 (the
    decode chain), with JAX's references."""
    jparams = jax_init(jax.random.PRNGKey(0), JaxConfig(**TP_KW))
    np_params = jax.tree.map(np.asarray, jparams)
    decode, ref_logits, ref_caches = _tp_decode_payload(
        jparams, _tp_caches(1), 3)
    requests = _tp_engine_requests()
    engines = {"chunked": TP_ENGINE_KW,
               "spec": dict(TP_ENGINE_KW, prefill_chunk=None, speculate_k=4)}
    refs = {}
    for name, kw in engines.items():
        eng = jserve.ServingEngine(jparams, JaxConfig(**TP_KW), **kw)
        for rid, p, n, pre in requests:
            eng.submit(rid, p, n, prefix_of=pre)
        refs[name] = eng.run(max_steps=120)
    base = {"cfg": TP_KW, "params": np_params, "decode": decode}
    runs = {2: run_ranks("serve_tp", 2, dict(
        base, engines={n: (kw, requests) for n, kw in engines.items()})),
        4: run_ranks("serve_tp", 4, base)}
    return runs, ref_logits, ref_caches, refs


@pytest.mark.parametrize("tp", [2, 4])
def test_tp_decode_matches_jax(tp_runs, tp):
    """``_decode_body(tp_group=)`` on each rank's shards (weights by
    ``param_specs``, the pages' kv heads split over the ranks) against
    JAX's single-device decode chain: logits replicated on every rank,
    each rank's pages the JAX pages' heads, lengths advanced."""
    runs, ref_logits, ref_caches, _ = tp_runs
    res = runs[tp]
    for rank, r in enumerate(res):
        for step, ref in enumerate(ref_logits):
            np.testing.assert_allclose(r[f"decode/logits{step}"], ref,
                                       atol=2e-5, rtol=1e-5)
        for i, c in enumerate(ref_caches):
            h = 4 // tp
            heads = slice(rank * h, (rank + 1) * h)
            for name, ref in (("k", c.k_pages), ("v", c.v_pages)):
                np.testing.assert_allclose(r[f"decode/{name}{i}"],
                                           ref[:, heads], atol=1e-5,
                                           rtol=1e-5)
            np.testing.assert_array_equal(r[f"decode/lens{i}"], c.seq_lens)


@pytest.mark.parametrize("name", ["chunked", "spec"])
def test_tp_engine_matches_jax(tp_runs, name):
    """``ServingEngine(mesh=group)`` at tp 2 over gloo (admissions,
    chunked prefill or speculation, prefix caching, decode, retirement
    all sharded) gives the JAX engine's tokens on every rank."""
    runs, _, _, refs = tp_runs
    for r in runs[2]:
        got = {rid: r[f"engine/{name}/{rid}"].tolist() for rid in refs[name]}
        assert got == refs[name]


def test_serving_example_runs_on_cpu():
    """``examples/serve_continuous_batching.py`` with speculation and
    chunked prefill on the CPU: every streamed request finishes with its
    tokens, prefills run in chunks and drafts are proposed."""
    from ring_flash_attn_tpu_torch.examples import serve_continuous_batching

    eng = serve_continuous_batching.main(
        ["--requests", "5", "--max-new", "6", "--device", "cpu",
         "--temperature", "0.8"])
    assert sorted(eng.outputs) == list(range(5))
    assert all(len(t) == 6 for t in eng.outputs.values())
    assert eng.stats["prefill_chunks"] > eng.stats["prefills"] > 0
    assert eng.stats["spec_proposed"] > 0
