"""The port's long-context inference path against the JAX package's on
identical numpy inputs, on the CPU: the process-group helpers, the
cross-shard merge, the sharded quantized decode and cache update, the
llama3 all-gather forward and the whole ``generate``; at W=1 in this
process (no process group: every collective is the identity) and at W=4
over gloo in spawned processes (``torch_dist_workers.py``), against the JAX
functions under ``shard_map`` over the same number of CPU devices."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

import torch_dist_workers as workers
from ring_flash_attn_tpu.models import ModelConfig as JaxConfig
from ring_flash_attn_tpu.models import generate as jgen
from ring_flash_attn_tpu.models.transformer import init_params as jax_init
from ring_flash_attn_tpu.ops import quant as jquant
from ring_flash_attn_tpu.parallel import decode as jdecode
from ring_flash_attn_tpu.parallel import llama3 as jllama3
from ring_flash_attn_tpu.parallel import mesh as jmesh

WORLDS = [1, 4]
# tests/test_generate.py's model and prompt
CFG = dict(vocab=128, dim=64, layers=2, heads=4, kv_heads=2, head_dim=16,
           mlp_dim=128, dtype="float32")
S, STEPS = 128, 6
F32_TOL = 1e-4  # an fp32 model on the plain / XLA paths of both packages
# a last-bit difference in K or V before rounding may move one int8 level
DECODE_TOL = 2e-3


def _sharded(world, in_specs, out_specs):
    mesh = Mesh(np.array(jax.devices("cpu")[:world]), ("sp",))
    return lambda f: jax.jit(shard_map(f, mesh=mesh, in_specs=in_specs,
                                       out_specs=out_specs, check_vma=False))


SEQ = P(None, None, "sp")  # (B, H, S, ...) sharded along the sequence


def _payloads(world):
    rng = np.random.default_rng(world)

    def f32(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    m_lse = f32(world, 2, 4, 3) * 3
    m_out = f32(world, 2, 4, 3, 8)
    m_lse[world // 2, 0] = -1e30  # a dead shard for some rows
    m_lse[:, 1, 2] = -1e30  # a row dead on every shard
    collectives = {"x": f32(world, 3, 5), "ct": f32(3, 5), "m_out": m_out,
                   "m_lse": m_lse}

    b, hq, hkv, s, d = 1, 8, 2, 512, 64
    jc = jquant.quantize_kv(jnp.asarray(f32(b, hkv, s, d)),
                            jnp.asarray(f32(b, hkv, s, d)))
    decode = {"qdtype": "int8", "scale": d**-0.5, "softcap": 20.0,
              "q": f32(b, hq, 1, d), "lengths": [512, 300, 1, 0],
              # inside one shard; the last slot of a shard with two tokens
              # (clamped so that they fit); the first slot
              "updates": [(s // world + 5 if world > 1 else 133,
                           f32(b, hkv, 1, d), f32(b, hkv, 1, d)),
                          (s // world - 1, f32(b, hkv, 2, d),
                           f32(b, hkv, 2, d)),
                          (0, f32(b, hkv, 1, d), f32(b, hkv, 1, d))]}
    decode.update({n: np.asarray(x) for n, x in zip(jc._fields, jc)})

    llama3 = {"q": f32(2, 4, 128, 16), "k": f32(2, 2, 128, 16),
              "v": f32(2, 2, 128, 16), "scale": 0.25,
              "variants": {"causal": {"causal": True},
                           "stride1": {"causal": True, "heads_k_stride": 1},
                           "full": {"causal": False}}}

    params = jax_init(jax.random.PRNGKey(0), JaxConfig(attention="llama3",
                                                       **CFG))
    generate = {"cfg": CFG, "steps": STEPS,
                "params": jax.tree.map(np.asarray, params),
                "prompt": rng.integers(0, CFG["vocab"], (1, S)).astype(
                    np.int64)}
    return {"collectives": collectives, "decode": decode, "llama3": llama3,
            "generate": generate}


def _jax_generate(world, p):
    """JAX's prefill logits (B, S, vocab), every decode step's logits
    (B, steps, vocab) and generate's tokens, under shard_map."""
    cfg = JaxConfig(attention="llama3", **CFG)
    params = jax.tree.map(jnp.asarray, p["params"])
    prompt = jnp.asarray(p["prompt"], jnp.int32)

    def body(params, prompt_local):
        w, rank = jmesh.ring_size("sp"), jmesh.ring_rank("sp")
        logits, caches = jgen.prefill(params, cfg, prompt_local, "sp")
        last = jax.lax.psum(jnp.where(rank == w - 1, logits[:, -1], 0.0),
                            "sp")
        token = jnp.argmax(last, -1).astype(jnp.int32)
        tails = [jquant.make_cache(1, cfg.kv_heads, STEPS, cfg.head_dim)
                 for _ in params["layers"]]
        fed, step_logits = [], []
        for step in range(STEPS):
            fed.append(token)
            lg, tails = jgen.decode_step(
                params, cfg, token, jnp.int32(S + step), step, caches, tails,
                "sp")
            step_logits.append(lg)
            token = jnp.argmax(lg, -1).astype(jnp.int32)
        toks = jgen.generate(params, cfg, prompt_local, STEPS, "sp")
        return (logits, jnp.stack(step_logits, 1), jnp.stack(fed, 1), toks)

    run = _sharded(world, (P(), P(None, "sp")),
                   (P(None, "sp"), P(), P(), P()))(body)
    return [np.asarray(x) for x in run(params, prompt)]


@functools.lru_cache(maxsize=None)
def _run(world):
    """(payloads, the port's results per rank, JAX's generate) for a world
    size; the port runs here at W=1 and in spawned gloo ranks otherwise."""
    p = _payloads(world)
    jax_gen = _jax_generate(world, p["generate"])
    p["generate"]["feed"] = jax_gen[2].astype(np.int64)
    if world == 1:
        res = [workers.task_all(0, 1, p)]
    else:
        res = workers.run_ranks("all", world, p)
    return p, res, jax_gen


def _cat(res, key, axis):
    return np.concatenate([r[key] for r in res], axis=axis)


@pytest.mark.parametrize("world", WORLDS)
def test_mesh_helpers(world):
    p, res, _ = _run(world)
    x, ct = p["collectives"]["x"], p["collectives"]["ct"]
    jrot = _sharded(world, P("sp"), P("sp"))(
        lambda a: jmesh.ring_rotate(a, "sp"))(jnp.asarray(x))
    jrev = _sharded(world, P("sp"), P("sp"))(
        lambda a: jmesh.ring_rotate(a, "sp", reverse=True))(jnp.asarray(x))
    total = sum(x[r] * np.float32(r + 1) for r in range(world))
    for r, out in enumerate(res):
        assert out["collectives/size"] == world
        assert out["collectives/rank"] == r
        np.testing.assert_array_equal(out["collectives/rotate"],
                                      np.asarray(jrot)[r])
        np.testing.assert_array_equal(out["collectives/rotate"],
                                      x[(r - 1) % world])
        np.testing.assert_array_equal(out["collectives/rotate_view"],
                                      x[(r - 1) % world])
        np.testing.assert_array_equal(out["collectives/rotate_rev"],
                                      np.asarray(jrev)[r])
        # posted and waited for later, two in flight at once
        np.testing.assert_array_equal(out["collectives/posted"],
                                      x[(r - 1) % world])
        np.testing.assert_array_equal(out["collectives/posted_rev"],
                                      2.0 * x[(r + 1) % world])
        # RingBuffer: one hop, then the full circle with W additions. At
        # step s rank r adds r + 1 to the value of rank r - s - 1
        np.testing.assert_array_equal(out["collectives/buffer_hop"],
                                      x[(r - 1) % world])
        np.testing.assert_allclose(
            out["collectives/buffer_home"],
            x[r] + np.float32(world * (world + 1) / 2), rtol=1e-6)
        np.testing.assert_array_equal(out["collectives/gather"],
                                      np.concatenate(list(x), axis=1))
        np.testing.assert_allclose(out["collectives/sum"], x.sum(0),
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_array_equal(out["collectives/max"], x.max(0))
        np.testing.assert_allclose(out["collectives/psum"], total, rtol=1e-6,
                                   atol=1e-6)
        # identity backward: the replicated cotangent, not W times it
        np.testing.assert_allclose(out["collectives/psum_grad"],
                                   ct * np.float32(r + 1), rtol=1e-6)


@pytest.mark.parametrize("world", WORLDS)
def test_merge_across_axis_matches_jax(world):
    p, res, _ = _run(world)
    c = p["collectives"]
    jo, jl = _sharded(world, (P("sp"), P("sp")), (P(), P()))(
        lambda o, l: jdecode.merge_across_axis(o[0], l[0], "sp"))(
            jnp.asarray(c["m_out"]), jnp.asarray(c["m_lse"]))
    for out in res:
        assert np.abs(out["collectives/merge_out"] - np.asarray(jo)).max() \
            <= 1e-6
        np.testing.assert_allclose(out["collectives/merge_lse"],
                                   np.asarray(jl), rtol=1e-6, atol=1e-6)
        assert np.all(out["collectives/merge_out"][1, 2] == 0)
        assert np.all(out["collectives/merge_lse"][1, 2] == -1e30)


def _jax_cache(p):
    return jquant.QuantizedKV(*(jnp.asarray(p[n])
                                for n in jquant.QuantizedKV._fields))


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_quant_decode_matches_jax(world):
    p, res, _ = _run(world)
    d = p["decode"]
    for n in d["lengths"]:
        jo, jl = _sharded(world, (P(), (SEQ,) * 4), (P(), P()))(
            lambda q, c: jdecode.sharded_quant_decode(
                q, jquant.QuantizedKV(*c), n, d["scale"], "sp",
                softcap=d["softcap"]))(jnp.asarray(d["q"]),
                                       tuple(_jax_cache(d)))
        for out in res:  # replicated: every rank holds the merged result
            assert np.abs(out[f"decode/out{n}"] - np.asarray(jo)).max() \
                <= F32_TOL, n
            np.testing.assert_allclose(out[f"decode/lse{n}"], np.asarray(jl),
                                       rtol=1e-6, atol=F32_TOL)
    assert np.all(res[0]["decode/out0"] == 0)
    assert np.all(res[0]["decode/lse0"] == -1e30)


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_cache_update_matches_jax(world):
    p, res, _ = _run(world)
    d = p["decode"]
    cache = tuple(_jax_cache(d))
    for i, (index, k_new, v_new) in enumerate(d["updates"]):
        cache = _sharded(world, ((SEQ,) * 4, P(), P()), (SEQ,) * 4)(
            lambda c, k, v: tuple(jdecode.sharded_cache_update(
                jquant.QuantizedKV(*c), k, v, index, "sp")))(
                    cache, jnp.asarray(k_new), jnp.asarray(v_new))
        for name, want in zip(jquant.QuantizedKV._fields, cache):
            got, want = _cat(res, f"decode/upd{i}_{name}", 2), np.asarray(want)
            # Under jit XLA folds the division by the constant 127 into a
            # multiplication by its reciprocal, one ulp off the true
            # quotient that both packages compute eagerly (held bit for bit
            # in test_torch_quant.py): a scale may differ in its last bit
            # and, at a tie, a value by one level.
            if name.endswith("scale"):
                np.testing.assert_allclose(got, want, rtol=3e-7, atol=0,
                                           err_msg=f"update {i}: {name}")
            else:
                diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
                assert diff.max() <= 1 and (diff != 0).mean() <= 1e-3, (
                    f"update {i} at {index}: {name}")


@pytest.mark.parametrize("world", WORLDS)
def test_llama3_forward_matches_jax(world):
    p, res, _ = _run(world)
    l3 = p["llama3"]
    for name, kw in l3["variants"].items():
        jo, jl = _sharded(world, (SEQ,) * 3, (SEQ, SEQ))(
            lambda q, k, v: jllama3.llama3_attention(
                q, k, v, None, scale=l3["scale"], axis_name="sp",
                backend="xla", **kw))(*(jnp.asarray(l3[n]) for n in "qkv"))
        assert np.abs(_cat(res, f"llama3/out_{name}", 2)
                      - np.asarray(jo)).max() <= F32_TOL, name
        assert np.abs(_cat(res, f"llama3/lse_{name}", 2)
                      - np.asarray(jl)).max() <= F32_TOL, name


@pytest.mark.parametrize("world", WORLDS)
def test_generate_matches_jax(world):
    """Prefill logits, each decode step's logits on the same fed tokens,
    and the generated tokens: the first equal and at least 5 of 6, the bar
    of tests/test_generate.py."""
    _, res, (j_prefill, j_steps, j_fed, j_toks) = _run(world)
    assert np.abs(_cat(res, "generate/prefill", 1) - j_prefill).max() \
        <= F32_TOL
    np.testing.assert_array_equal(j_fed, j_toks)  # the scan emits its inputs
    for out in res:
        assert np.abs(out["generate/steps"] - j_steps).max() <= DECODE_TOL
        toks = out["generate/tokens"]
        assert toks.shape == (1, STEPS) and toks.dtype == np.int32
        np.testing.assert_array_equal(toks, res[0]["generate/tokens"])
        assert toks[0, 0] == j_toks[0, 0]
        assert int((toks == j_toks).sum()) >= STEPS - 1, (toks, j_toks)


def test_llama3_attention_refuses_what_is_not_ported():
    """dropout and window_left, which raised before the window/dropout
    slice, compute: at one process, the flash entry's result (each head
    chunk's dropout with its global head ids); softcap and ALiBi (ported
    with the softcap/ALiBi slice) too; packed sequences (q_segids, ported
    with the varlen slice) compute: at one process, two segments equal
    the two halves attended apart."""
    import torch

    from ring_flash_attn_tpu_torch.ops import MaskArgs, flash_attention
    from ring_flash_attn_tpu_torch.parallel import llama3_attention

    q = torch.zeros(1, 2, 8, 16)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (1, 2, 8, 16)).astype(np.float32))
    for kw in ({"dropout_p": 0.1, "dropout_seed": 3}, {"window_left": 4}):
        got, _ = llama3_attention(x, x, x, scale=0.25, heads_k_stride=1,
                                  **kw)
        want, _ = flash_attention(x, x, x, 0.25, MaskArgs(causal=True, **kw))
        assert float((got - want).abs().max()) <= 1e-6, kw
    for kw in ({"softcap": 10.0}, {"alibi_slopes": torch.tensor([0.5, 2.0])},
               {"softcap": 3.0, "alibi_slopes": torch.tensor([0.5, 2.0])}):
        for causal in (True, False):
            got, _ = llama3_attention(x, x, x, scale=0.25, causal=causal,
                                      heads_k_stride=1, **kw)
            want, _ = flash_attention(x, x, x, 0.25,
                                      MaskArgs(causal=causal, **kw))
            assert float((got - want).abs().max()) <= 1e-6, (kw, causal)
    seg = torch.tensor([0] * 3 + [5] * 5, dtype=torch.int32)
    out, _ = llama3_attention(x, x, x, seg, scale=0.25)
    for part in (slice(0, 3), slice(3, 8)):
        y = x[:, :, part]
        want, _ = llama3_attention(y, y, y, scale=0.25)
        assert float((out[:, :, part] - want).abs().max()) <= 1e-6
    with pytest.raises(ValueError):
        llama3_attention(q, q, q, scale=1.0, heads_k_stride=3)
    with torch.no_grad():
        out, lse = llama3_attention(q.clone().requires_grad_(), q, q,
                                    scale=1.0)
    assert out.shape == q.shape and lse.shape == q.shape[:3]


def test_workers_fail_fast(monkeypatch):
    """A rank that raises fails the run with its traceback, and no worker
    is left behind."""
    monkeypatch.setattr(workers, "START_TIMEOUT", 60)
    with pytest.raises(RuntimeError, match="no such task|KeyError"):
        workers.run_ranks("no such task", 2, {})
