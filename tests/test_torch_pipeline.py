"""The port's GPipe pipeline (ring_flash_attn_tpu_torch.models.pipeline)
against the JAX package's (tests/test_model.py's pipeline test): one
``train_step_pp`` on a (pp 2, sp 2) grid, on 4 stages and on a (dp 2, pp 2)
grid with a data group over gloo (tests/torch_dist_workers.py) against
JAX's ``train_step_pp`` under shard_map on the same weights and batch, and
one stage in process against the port's ``train_step``."""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from ring_flash_attn_tpu.models import ModelConfig as JaxConfig
from ring_flash_attn_tpu.models import forward as jax_forward
from ring_flash_attn_tpu.models import pipeline as jpipe
from ring_flash_attn_tpu.models import prepare_zigzag_batch
from ring_flash_attn_tpu.models.transformer import init_params as jax_init
from ring_flash_attn_tpu_torch.models import (ModelConfig, forward_pp,
                                              init_params, pipeline_specs,
                                              stack_layers, train_step,
                                              train_step_pp)
from ring_flash_attn_tpu_torch.parallel import layouts

from torch_dist_workers import run_ranks

CFG_KW = dict(vocab=128, dim=64, layers=4, heads=4, kv_heads=2, head_dim=16,
              mlp_dim=128, attention="zigzag", dtype="float32")
S, M, BMB, LR = 64, 2, 2, 1e-2


def _jax_pp(devices, pp, sp, params, tokens, m):
    """JAX's ``train_step_pp`` on a (pp, sp) mesh: (the batch in the
    zigzag layout over sp, new stacked parameters, loss)."""
    cfg = JaxConfig(**CFG_KW)
    mesh = Mesh(np.array(devices[:pp * sp]).reshape(pp, sp), ("pp", "sp"))
    t_l, l_l, pos = prepare_zigzag_batch(tokens, sp)
    specs = jpipe.pipeline_specs(cfg, "pp")

    @partial(shard_map, mesh=mesh,
             in_specs=(specs, P(None, "sp"), P(None, "sp"), P("sp")),
             out_specs=(specs, P()), check_vma=False)
    def step(params_, tokens_, labels_, pos_):
        return jpipe.train_step_pp(params_, cfg, tokens_, labels_, pos_, "pp",
                                   m, lr=LR, axis_name="sp")

    new, loss = jax.jit(step)(jpipe.stack_layers(params, pp), t_l, l_l, pos)
    return (t_l, l_l, pos), jax.tree.map(np.asarray, new), float(loss)


@pytest.fixture(scope="module")
def pp_runs(devices8):
    """(pp 2, sp 2) with 2 microbatches and 4 stages with 3, each against
    JAX's run on the same grid."""
    params = jax_init(jax.random.PRNGKey(0), JaxConfig(**CFG_KW))
    np_params = jax.tree.map(np.asarray, params)
    out = {}
    for pp, sp, m in ((2, 2, M), (4, 1, 3)):
        tokens = jax.random.randint(jax.random.PRNGKey(1), (m * BMB, S), 0,
                                    CFG_KW["vocab"], jnp.int32)
        batch, new, loss = _jax_pp(devices8, pp, sp, params, tokens, m)
        # the logits before the step, in the batch's zigzag layout
        logits = jax_forward(params, JaxConfig(**CFG_KW), tokens,
                             jnp.arange(S, dtype=jnp.int32))
        zz = layouts.all_local_zigzag(torch.from_numpy(np.array(logits)),
                                      sp, axis=1).numpy()
        res = run_ranks("pipeline", pp * sp, {
            "cfg": CFG_KW, "params": np_params, "sp": sp, "m": m, "lr": LR,
            "tokens": np.asarray(batch[0]), "labels": np.asarray(batch[1]),
            "pos": np.asarray(batch[2])})
        out[(pp, sp)] = res, new, loss, zz
    return out


GRIDS = [(2, 2), (4, 1)]


@pytest.mark.parametrize("pp,sp", GRIDS)
def test_train_step_pp_matches_jax(pp_runs, pp, sp):
    """The loss on every rank, each stage's updated layers and the
    replicated embed, final_norm and lm_head against JAX's stacked
    result."""
    res, new, loss, _ = pp_runs[(pp, sp)]
    per = CFG_KW["layers"] // pp
    for rank, r in enumerate(res):
        assert abs(float(r["loss"]) - loss) < 1e-5, (rank, r["loss"], loss)
        stage = rank // sp
        for name in ("embed", "final_norm", "lm_head"):
            np.testing.assert_allclose(r[name], new[name], atol=2e-5)
        for i in range(per):
            for leaf, ref in new["layers"].items():
                np.testing.assert_allclose(r[f"layers.{i}.{leaf}"],
                                           ref[stage * per + i], atol=2e-5,
                                           err_msg=f"rank {rank} {leaf}")


def test_train_step_pp_data_group_matches_jax(devices8):
    """``train_step_pp(data_group=)`` on a (dp 2, pp 2) grid, sp 1, the two
    data replicas on different halves of the batch: each rank's loss (the
    mean over dp) and its stage's updated parameters (gradients summed
    over dp, and over pp for the embed, final_norm and lm_head) against
    JAX's ``train_step_pp(data_axis="dp")`` on the same mesh."""
    dp, pp, m = 2, 2, M
    cfg = JaxConfig(**CFG_KW)
    params = jax_init(jax.random.PRNGKey(0), cfg)
    tokens = jax.random.randint(jax.random.PRNGKey(2), (dp * m * BMB, S), 0,
                                CFG_KW["vocab"], jnp.int32)
    labels = jnp.concatenate([tokens[:, 1:], jnp.full_like(tokens[:, :1],
                                                           -100)], axis=1)
    pos = jnp.arange(S, dtype=jnp.int32)
    mesh = Mesh(np.array(devices8[:dp * pp]).reshape(dp, pp), ("dp", "pp"))
    specs = jpipe.pipeline_specs(cfg, "pp")

    @partial(shard_map, mesh=mesh,
             in_specs=(specs, P("dp", None), P("dp", None), P()),
             out_specs=(specs, P()), check_vma=False)
    def step(params_, tokens_, labels_, pos_):
        return jpipe.train_step_pp(params_, cfg, tokens_, labels_, pos_, "pp",
                                   m, lr=LR, data_axis="dp")

    new, loss = jax.jit(step)(jpipe.stack_layers(params, pp), tokens, labels,
                              pos)
    new, loss = jax.tree.map(np.asarray, new), float(loss)
    res = run_ranks("pipeline", dp * pp, {
        "cfg": CFG_KW, "params": jax.tree.map(np.asarray, params), "sp": 1,
        "dp": dp, "m": m, "lr": LR, "tokens": np.asarray(tokens),
        "labels": np.asarray(labels), "pos": np.asarray(pos)})
    per = CFG_KW["layers"] // pp
    # every rank reports the one loss, the mean over dp
    assert len({round(float(r["loss"]), 6) for r in res}) == 1
    for rank, r in enumerate(res):
        assert abs(float(r["loss"]) - loss) < 1e-5, (rank, r["loss"], loss)
        stage = rank % pp
        for name in ("embed", "final_norm", "lm_head"):
            np.testing.assert_allclose(r[name], new[name], atol=2e-5)
        for i in range(per):
            for leaf, ref in new["layers"].items():
                np.testing.assert_allclose(r[f"layers.{i}.{leaf}"],
                                           ref[stage * per + i], atol=2e-5,
                                           err_msg=f"rank {rank} {leaf}")


@pytest.mark.parametrize("pp,sp", GRIDS)
def test_forward_pp_logits_on_last_stage(pp_runs, pp, sp):
    """``forward_pp``: logits on the last stage only, JAX's single-device
    forward's in the zigzag layout over sp."""
    res, _, _, zz = pp_runs[(pp, sp)]
    last = res[(pp - 1) * sp:]
    assert all("logits" not in r for r in res[:(pp - 1) * sp])
    got = np.concatenate([r["logits"] for r in last], axis=1)
    np.testing.assert_allclose(got, zz, atol=2e-5)


def test_one_stage_matches_train_step():
    """``pp_group=False`` (one stage) with 2 microbatches: the loss and
    every parameter of ``train_step`` on the whole batch."""
    cfg = ModelConfig(**CFG_KW)
    model = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    stage = stack_layers(model, cfg, device="cpu")
    gen = torch.Generator().manual_seed(1)
    tokens = torch.randint(0, cfg.vocab, (M * BMB, S), generator=gen)
    labels = torch.cat([tokens[:, 1:], torch.full_like(tokens[:, :1], -100)],
                       dim=1)
    pos = torch.arange(S)
    _, ref = train_step(model, tokens, labels, pos, lr=LR)
    _, loss = train_step_pp(stage, tokens, labels, pos, False, M, lr=LR)
    assert abs(float(loss) - float(ref)) < 1e-6
    for (n, a), (_, b) in zip(model.named_parameters(),
                              stage.named_parameters()):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=0, msg=n)


def test_stack_layers_and_specs():
    """``stack_layers`` cuts stage s's layers [s L / pp, (s + 1) L / pp)
    from the JAX tree; ``pipeline_specs`` names that stage for each layer
    parameter and None for the replicated ones."""
    params = jax.tree.map(np.asarray,
                          jax_init(jax.random.PRNGKey(0),
                                   JaxConfig(**CFG_KW)))
    cfg = ModelConfig(**CFG_KW)
    specs = pipeline_specs(cfg, 2)
    assert specs["embed"] is specs["lm_head"] is specs["final_norm"] is None
    for s in range(2):
        stage = stack_layers(params, cfg, pp_rank=s, pp=2, device="cpu")
        assert len(stage.layers) == 2
        for i in range(2):
            assert specs[f"layers.{2 * s + i}.wq"] == s
            np.testing.assert_array_equal(
                stage.layers[i].wq.detach().numpy(),
                params["layers"][2 * s + i]["wq"])
    with pytest.raises(ValueError, match="do not split"):
        stack_layers(params, cfg, pp=3, device="cpu")


def test_moe_models_are_refused():
    """The stages run dense MLPs only, as JAX's pipeline does: a MoE
    config raises in ``stack_layers`` and a MoE model in ``forward_pp``."""
    cfg = ModelConfig(**dict(CFG_KW, moe_experts=2))
    model = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(NotImplementedError, match="dense MLPs only"):
        stack_layers(model, cfg, device="cpu")
    tokens = torch.zeros((M * BMB, S), dtype=torch.long)
    with pytest.raises(NotImplementedError, match="dense MLPs only"):
        forward_pp(model, tokens, torch.arange(S), False, M)
