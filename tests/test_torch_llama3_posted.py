"""llama3's collectives posted ahead (``parallel/llama3.py`` over
``mesh.all_gather_start`` and ``mesh.reduce_scatter_start``), as the JAX
module schedules its head chunks' ``all_gather`` and ``psum_scatter``.

One set of W=4 gloo processes (``torch_dist_workers.py``, task
``llama3_posted``) runs ``llama3_attention``'s forward and backward and,
beside it, the module's rank functions over the blocking collectives; the
two must agree bit for bit, and both match JAX's ``llama3_attention``
under ``shard_map`` (at the tolerance of ``tests/test_torch_tp_moe.py``).
The same processes log the order in which the posted collectives and the
block kernels run. On the CPU the block calls run the plain versions of
kernels B1 and B2/B3; JAX runs its XLA path.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

import torch_dist_workers as workers
from ring_flash_attn_tpu.parallel import llama3 as jllama3
from ring_flash_attn_tpu_torch.parallel.mesh import (
    Posted, all_gather_start, reduce_scatter_start)

WORLD = 4
# 4 kv heads so that heads_k_stride 1 makes 4 chunks; GQA group 2
Q, KV, SCALE = (1, 8, 128, 16), (1, 4, 128, 16), 0.25
L3_TOL = 1e-4  # tests/test_torch_tp_moe.py's
VARIANTS = {
    "causal_stride1": {"causal": True, "heads_k_stride": 1},
    "full_stride2": {"causal": False, "heads_k_stride": 2},
    "packed_stride1": {"causal": True, "heads_k_stride": 1, "packed": True},
    "softcap_window": {"causal": True, "heads_k_stride": 2, "softcap": 5.0,
                       "window_left": 40},
    "dropout": {"causal": True, "heads_k_stride": 1, "dropout_p": 0.1,
                "dropout_seed": 3},
}
# JAX's backward with dropout is held elsewhere against the port's
# single-device call (tests/test_torch_xform_dist.py)
JAX_VARIANTS = [n for n in VARIANTS if n != "dropout"]
KEYS = ("out", "lse", "dq", "dk", "dv")


def _np(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _segids(seed=70):
    """Segment labels of a seeded packing of the 128 tokens, documents
    crossing the ranks' shards."""
    rng = np.random.default_rng(seed)
    lens = []
    while sum(lens) < Q[2] - 40:
        lens.append(int(rng.integers(10, 40)))
    lens.append(Q[2] - sum(lens))
    return np.repeat(np.arange(len(lens)), lens).astype(np.int32)


def _payload():
    return {"q": _np(Q, 71), "k": _np(KV, 72), "v": _np(KV, 73),
            "dout": _np(Q, 74), "segids": _segids(), "scale": SCALE,
            "variants": VARIANTS, "order": "causal_stride1",
            "x": _np((WORLD, 2 * WORLD, 4 * WORLD, WORLD), 75)}


@functools.lru_cache(maxsize=None)
def _runs():
    return workers.run_ranks("llama3_posted", WORLD, _payload())


def _cat(res, key):
    return np.concatenate([r[key] for r in res], axis=2)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_llama3_posted_collectives_are_the_blocking_ones_bitwise(variant):
    """out, lse, dq, dk and dv of every rank with the gathers and
    reduce-scatters posted ahead equal, bit for bit, those of the same
    rank functions over the blocking collectives."""
    for r, res in enumerate(_runs()):
        for key in KEYS:
            np.testing.assert_array_equal(
                res[f"posted/{key}_{variant}"],
                res[f"blocking/{key}_{variant}"],
                err_msg=f"rank {r}: {key}")


@pytest.mark.parametrize("variant", JAX_VARIANTS)
def test_llama3_posted_collectives_match_jax(variant):
    """The posted path's out, lse and gradients of every rank against JAX
    ``llama3_attention`` under shard_map, as tests/test_torch_tp_moe.py
    holds the default variants."""
    p = _payload()
    kw = dict(VARIANTS[variant])
    packed = kw.pop("packed", False)
    seq = P(None, None, "sp")
    mesh = Mesh(np.array(jax.devices("cpu")[:WORLD]), ("sp",))

    @functools.partial(shard_map, mesh=mesh,
                       in_specs=(seq,) * 3 + (P("sp"),),
                       out_specs=(seq, seq), check_vma=False)
    def run(q, k, v, segids):
        return jllama3.llama3_attention(
            q, k, v, segids if packed else None, scale=SCALE,
            axis_name="sp", backend="xla", **kw)

    (out, lse), vjp = jax.vjp(
        jax.jit(run), *(jnp.asarray(p[n]) for n in ("q", "k", "v")),
        jnp.asarray(p["segids"]))
    grads = vjp((jnp.asarray(p["dout"]), jnp.zeros_like(lse)))[:3]
    res = _runs()
    for key, ref in zip(KEYS, (out, lse, *grads)):
        got = _cat(res, f"posted/{key}_{variant}")
        err = np.abs(got - np.asarray(ref)).max()
        assert err <= L3_TOL * max(1.0, np.abs(np.asarray(ref)).max()), (
            key, err)


def _expected_events(chunks):
    """The order llama3's forward and backward run their posted
    collectives and kernels in over ``chunks`` head chunks: chunk n + 1's
    gather posted before chunk n's kernel; each chunk's dk and dv
    reduce-scatters posted after its kernel and waited for after the next
    chunk's kernel, or at the end."""
    fwd, bwd = ["post g0", "wait g0"], [f"post g{chunks}", f"wait g{chunks}"]
    for n in range(chunks):
        if n + 1 < chunks:
            fwd.append(f"post g{n + 1}")
            bwd.append(f"post g{chunks + n + 1}")
        fwd.append("fwd")
        bwd.append("bwd")
        if n:
            bwd += ["wait rs", "wait rs"]
        bwd += ["post rs", "post rs"]
        if n + 1 < chunks:
            fwd.append(f"wait g{n + 1}")
            bwd.append(f"wait g{chunks + n + 1}")
    return fwd + bwd + ["wait rs", "wait rs"]


def test_llama3_posts_each_gather_before_the_previous_chunks_kernel():
    """With heads_k_stride 1 over 4 kv heads (4 chunks), every rank posts
    chunk n + 1's gather before chunk n's ``block_fwd``/``block_bwd``,
    waits for each chunk's reduce-scatters only after the next chunk's
    kernel, and holds at most two gathered chunks at once (the reference's
    double buffer)."""
    want = _expected_events(KV[1])
    for r, res in enumerate(_runs()):
        assert list(res["events"]) == want, f"rank {r}"
        assert int(res["most_alive"]) == 2, f"rank {r}"


@pytest.mark.parametrize("dim", [0, 1, -1])
def test_posted_gather_and_reduce_scatter_are_the_blocking_ones(dim):
    """``all_gather_start``/``reduce_scatter_start`` then ``wait()`` give
    the blocking collectives' results bit for bit over gloo at W=4."""
    for res in _runs():
        for what in ("gather", "scatter"):
            np.testing.assert_array_equal(res[f"{what}{dim}"],
                                          res[f"{what}{dim}_blocking"])


def test_posted_collectives_post_nothing_at_world_size_one():
    """Without a process group (a world of one) the posted forms post
    nothing: ``wait()`` returns x itself, and again on a second call."""
    x = torch.arange(6.0).reshape(2, 3)
    for posted in (all_gather_start(x, 1), reduce_scatter_start(x, 0)):
        assert isinstance(posted, Posted)
        assert posted.wait() is x and posted.wait() is x
