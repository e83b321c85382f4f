"""The decode paths of kernels B5, B4 and B6 at head dims 64 and 256 and
past the 16 rows a kv head that the small-row loop serves (multi-query
groups of 48 and 71 q heads a kv head, Tq 1 and 5; the row tile's edges
at 63, 64, 65 and 129 rows), the port against the JAX package on
identical numpy inputs.

On the CPU the port's entry points (``paged_decode_attention``,
``quant_decode_attention``, ``paged_quant_decode_attention``) run the
kernels' plain versions, which the card holds each kernel against
(``tests/test_torch_cuda.py``); JAX runs its Pallas kernels in interpret
mode and its XLA paths. Tolerances: 1e-5 against an XLA path that computes
the same fp32 formula; 1e-2 against a Pallas kernel, which rounds
q * scale and p to bf16 (2^-9 of each, logits of a few units): over the
272640 outputs of 71 x 5 rows at head dim 256 its error reaches 6e-3,
past the 5e-3 that tests/test_torch_paged_quant.py sets at 4 rows of 64.
On int8 pages both sides quantize q per row.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ring_flash_attn_tpu.ops import paged as jpaged
from ring_flash_attn_tpu.ops import quant as jquant
from ring_flash_attn_tpu_torch.ops import paged as tpaged
from ring_flash_attn_tpu_torch.ops import quant as tquant
from ring_flash_attn_tpu_torch.ops.quant_decode_cuda import MAX_ROWS

XLA_TOL = 1e-5
PALLAS_TOL = 1e-2
# (head dim, q heads a kv head): StarCoder's 48 and Falcon-7B's 71 at the
# decode loop's new head dims
SHAPES = [(64, 48), (64, 71), (256, 48), (256, 71)]
B, HKV, PS, PPS = 3, 1, 16, 16
# lanes of 100 and 200 tokens and a dead one: the Pallas kernels' bf16
# rounding averages out over a hundred tokens or more
LENS = [100, 0, 200]
S = 256  # B4's cache: a multiple of 128, so JAX takes its Pallas kernel


def _close(got, want, tol, what):
    for name, a, r in zip(("out", "lse"), got, want):
        assert a.shape == tuple(r.shape), (what, name)
        np.testing.assert_allclose(a.numpy(), np.asarray(r), rtol=0,
                                   atol=tol, err_msg=f"{what} {name}")


def _q(rng, d, g, tq):
    return rng.standard_normal((B, g * HKV, tq, d)).astype(np.float32)


@pytest.mark.parametrize("tq", [1, 5])
@pytest.mark.parametrize("d,g", SHAPES)
def test_paged_decode_rows_match_jax(d, g, tq):
    """B5's route: Tq rows with new_counts (a speculative verify of
    Tq - 1 drafts; lanes whose counts are Tq, 0 and Tq - 2) and softcap,
    G * Tq rows a kv head in row tiles of 128 (64 at 256) on the card,
    against JAX's ``paged_decode_attention``."""
    rng = np.random.default_rng(d + g + tq)
    n = B * PPS
    k, v = (rng.standard_normal((n, HKV, PS, d)).astype(np.float32)
            for _ in range(2))
    tables = rng.permutation(n).reshape(B, PPS).astype(np.int32)
    lens = np.asarray(LENS, np.int32)
    counts = np.asarray([tq, 0, max(1, tq - 2)], np.int32)
    q = _q(rng, d, g, tq)
    scale = d ** -0.5
    assert g * tq > MAX_ROWS[d]  # the row-tile loop's rows
    got = tpaged.paged_decode_attention(
        torch.from_numpy(q),
        tpaged.PagedKVCache(*(torch.from_numpy(x)
                              for x in (k, v, tables, lens))),
        scale, softcap=20.0, new_counts=torch.from_numpy(counts))
    jc = jpaged.PagedKVCache(*(jnp.asarray(x) for x in (k, v, tables, lens)))
    for backend, tol in (("xla", XLA_TOL), ("pallas_interpret", PALLAS_TOL)):
        want = jpaged.paged_decode_attention(
            jnp.asarray(q), jc, scale, softcap=20.0, backend=backend,
            new_counts=jnp.asarray(counts))
        _close(got, want, tol, f"B5 {backend}")
    assert torch.all(got[0][1] == 0) and torch.all(got[1][1] == -1e30)


@pytest.mark.parametrize("qdtype", ["int8", "fp8_e5m2"])
@pytest.mark.parametrize("tq", [1, 5])
@pytest.mark.parametrize("d,g", SHAPES)
def test_quant_decode_rows_match_jax(d, g, tq, qdtype):
    """B4's route at G * Tq rows a kv head, a length short of the cache,
    against JAX's ``quant_decode_attention`` (its Pallas kernel and its
    XLA path)."""
    rng = np.random.default_rng(2 * d + g + tq)
    k, v = (rng.standard_normal((B, HKV, S, d)).astype(np.float32)
            for _ in range(2))
    q = _q(rng, d, g, tq)
    scale = d ** -0.5
    jc = jquant.quantize_kv(jnp.asarray(k), jnp.asarray(v), qdtype)
    tc = tquant.quantize_kv(torch.from_numpy(k), torch.from_numpy(v), qdtype)
    got = tquant.quant_decode_attention(torch.from_numpy(q), tc, 201, scale,
                                        softcap=30.0)
    for backend, tol in (("xla", XLA_TOL), ("pallas_interpret", PALLAS_TOL)):
        want = jquant.quant_decode_attention(jnp.asarray(q), jc, 201, scale,
                                             softcap=30.0, backend=backend)
        _close(got, want, tol, f"B4 {qdtype} {backend}")


@pytest.mark.parametrize("tq", [1, 5])
@pytest.mark.parametrize("d,g", SHAPES)
def test_paged_quant_decode_rows_match_jax(d, g, tq):
    """B6's route at G * Tq rows a kv head: int8 pages (both sides
    quantize q per row) against JAX's Pallas kernel, fp8 e4m3 pages also
    against its XLA path (the same fp32 formula, q as it is)."""
    rng = np.random.default_rng(3 * d + g + tq)
    n = B * PPS
    k, v = (rng.standard_normal((B, HKV, PPS * PS, d)).astype(np.float32)
            for _ in range(2))
    tables = rng.permutation(n).reshape(B, PPS).astype(np.int32)
    q = _q(rng, d, g, tq)
    scale = d ** -0.5
    for qdtype in ("int8", "fp8_e4m3"):
        jc = jpaged.paged_quant_prefill(
            jpaged.paged_quant_init(B, HKV, n, PS, PPS, d, qdtype=qdtype,
                                    block_tables=tables),
            jnp.asarray(k), jnp.asarray(v), jnp.asarray(LENS, jnp.int32))
        tc = tpaged.paged_quant_prefill(
            tpaged.paged_quant_init(B, HKV, n, PS, PPS, d, qdtype=qdtype,
                                    block_tables=tables, device="cpu"),
            torch.from_numpy(k), torch.from_numpy(v), LENS)
        got = tpaged.paged_quant_decode_attention(torch.from_numpy(q), tc,
                                                  scale, softcap=15.0)
        backends = [("pallas_interpret", PALLAS_TOL)]
        if qdtype != "int8":
            backends.append(("xla", XLA_TOL))
        for backend, tol in backends:
            want = jpaged.paged_quant_decode_attention(
                jnp.asarray(q), jc, scale, softcap=15.0, backend=backend)
            if backend == "xla":  # no dead-lane guard there (ROADMAP C10)
                got_, want = [x[::2] for x in got], [x[::2] for x in want]
            else:
                got_ = got
            _close(got_, want, tol, f"B6 {qdtype} {backend}")
        assert torch.all(got[0][1] == 0) and torch.all(got[1][1] == -1e30)


# the row tile's edges (csrc/quant_decode.cuh::row_tile: two consumer
# warpgroups of 64 rows, one at 256), (head dim, G, Tq): 63 rows in one
# warpgroup short of its 64, 64 exactly, 65 past one warpgroup at 256 (two
# tiles there), 129 past two (two tiles at 128)
TILE_EDGES = [(64, 63, 1), (128, 16, 4), (256, 13, 5), (128, 43, 3)]


@pytest.mark.parametrize("kernel", ["B5", "B4", "B6"])
@pytest.mark.parametrize("d,g,tq", TILE_EDGES)
def test_row_tile_edges_match_jax(d, g, tq, kernel):
    """B5's, B4's (int8) and B6's routes at the row tile's edges, as the
    tests above hold them against JAX."""
    if kernel == "B5":
        test_paged_decode_rows_match_jax(d, g, tq)
    elif kernel == "B4":
        test_quant_decode_rows_match_jax(d, g, tq, "int8")
    else:
        test_paged_quant_decode_rows_match_jax(d, g, tq)
