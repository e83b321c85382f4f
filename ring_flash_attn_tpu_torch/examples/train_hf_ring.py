"""End to end: train a torch transformers Llama through ring attention.

The port of ``examples/train_hf_flax_ring.py`` (the reference's flagship
integration: patch HF transformers, train an unmodified causal LM with
ring attention):

  1. Build ``LlamaForCausalLM`` in code from a ``LlamaConfig`` with
     Llama-3.2's architecture (4:1 GQA, rope theta 500k, silu MLP) at a
     reduced depth and width (``--full-dims``: Llama-3.2-1B's own), with
     seeded random weights; nothing is downloaded.
  2. ``substitute_hf_flash_attn()``: the model is not modified; its
     attention routes through llama3 all-gather context parallelism
     (``adapters/adapter.py``).
  3. Pack three documents into one batch_size == 1 sequence whose
     position_ids restart at each document: they carry the packing to the
     attention on every rank.
  4. ``--world`` processes, each with a contiguous shard of the sequence:
     the loss is the packed next-token cross-entropy summed over the
     ranks, the gradients are summed over them, and ``torch.optim.AdamW``
     steps; the loss falls over the steps (asserted).

Run (transformers must be installed):

    python -m ring_flash_attn_tpu_torch.examples.train_hf_ring --device cpu

``--device cpu`` runs gloo processes on the CPU (the kernels' plain
versions); the default, ``cuda``, runs one process a card over NCCL
(``--world`` cards) through the kernels.
"""

import argparse
import os
import queue
import socket
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402
import torch.multiprocessing as mp  # noqa: E402
import torch.nn.functional as F  # noqa: E402

TIMEOUT = 600  # seconds for every rank to report


def build_model(full_dims, seq_len):
    os.environ.setdefault("USE_TF", "0")
    from transformers import LlamaConfig, LlamaForCausalLM

    if full_dims:  # Llama-3.2-1B's architecture
        cfg = LlamaConfig(
            vocab_size=128256, hidden_size=2048, intermediate_size=8192,
            num_hidden_layers=16, num_attention_heads=32,
            num_key_value_heads=8, rope_theta=500000.0,
            max_position_embeddings=max(seq_len, 131072),
            tie_word_embeddings=True)
    else:  # the same ratios (4:1 GQA, 4x MLP) at a test's size
        cfg = LlamaConfig(
            vocab_size=512, hidden_size=128, intermediate_size=512,
            num_hidden_layers=2, num_attention_heads=8,
            num_key_value_heads=2, rope_theta=500000.0,
            max_position_embeddings=max(seq_len, 4096))
    torch.manual_seed(0)
    return LlamaForCausalLM(cfg).float()


def pack_batch(seed, vocab, doc_lens):
    """(tokens, position_ids, targets, weights), each (1, sum(lens)):
    positions restart at each document; a document's last token predicts
    nothing (weight 0)."""
    total = sum(doc_lens)
    tokens = np.random.default_rng(seed).integers(0, vocab, size=(1, total))
    pos = np.concatenate([np.arange(n) for n in doc_lens])[None]
    weights = np.ones((1, total), np.float32)
    weights[0, np.cumsum(doc_lens) - 1] = 0.0
    return tokens, pos, np.roll(tokens, -1, axis=1), weights


def train_rank(rank, world, port, args, results):
    """One rank: join the group, train, report the losses (rank 0)."""
    from ring_flash_attn_tpu_torch import adapters
    from ring_flash_attn_tpu_torch.parallel.mesh import (all_reduce,
                                                         psum_exact)

    try:
        cuda = args.device == "cuda"
        if cuda:
            torch.cuda.set_device(rank)
        dist.init_process_group("nccl" if cuda else "gloo",
                                init_method=f"tcp://localhost:{port}",
                                world_size=world, rank=rank)
        try:
            dev = torch.device("cuda", rank) if cuda else torch.device("cpu")
            model = build_model(args.full_dims, args.seq_len).to(dev)
            adapters.substitute_hf_flash_attn()  # the default group
            a = args.seq_len // 4
            batch = pack_batch(1, model.config.vocab_size,
                               [a, 2 * a, args.seq_len - 3 * a])
            l = args.seq_len // world
            toks, pos, targets, weights = (
                torch.from_numpy(x[:, rank * l:(rank + 1) * l]).to(dev)
                for x in batch)
            count = all_reduce(weights.sum())
            opt = torch.optim.AdamW(model.parameters(), lr=3e-3)
            losses = []
            for _ in range(args.steps):
                logits = model(toks, position_ids=pos, use_cache=False).logits
                nll = F.cross_entropy(logits[0].float(), targets[0],
                                      reduction="none")
                # the sum over ranks whose backward is the identity: each
                # rank's tokens take their share of the global mean
                loss = psum_exact((nll * weights[0]).sum()) / count
                opt.zero_grad()
                loss.backward()
                for p in model.parameters():
                    p.grad = all_reduce(p.grad)
                opt.step()
                losses.append(float(loss))
        finally:
            dist.destroy_process_group()
        results.put((rank, losses, None))
    except Exception as e:  # reported to the parent, which fails
        results.put((rank, None, repr(e)))
        raise


def _free_port():
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--seq-len", type=int, default=512)
    ap.add_argument("--world", type=int, default=4)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--full-dims", action="store_true",
                    help="Llama-3.2-1B's dims (needs real memory)")
    args = ap.parse_args(argv)
    if args.seq_len % (4 * args.world):
        raise SystemExit("--seq-len must divide into 4 * --world parts")
    if args.device == "cuda" and torch.cuda.device_count() < args.world:
        raise SystemExit(f"--device cuda needs {args.world} cards, found "
                         f"{torch.cuda.device_count()}; pass --device cpu")
    # the ranks import this function by its module, whichever way this
    # file was started
    from ring_flash_attn_tpu_torch.examples.train_hf_ring import train_rank

    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=train_rank,
                         args=(r, args.world, port, args, results))
             for r in range(args.world)]
    for p in procs:
        p.start()
    got = {}
    try:
        for _ in range(args.world):
            try:
                rank, losses, err = results.get(timeout=TIMEOUT)
            except queue.Empty:
                raise SystemExit(f"ranks {sorted(got)} of {args.world} "
                                 f"reported within {TIMEOUT} s") from None
            if err is not None:
                raise SystemExit(f"rank {rank} failed: {err}")
            got[rank] = losses
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
    losses = got[0]
    for step, loss in enumerate(losses):
        if step % 5 == 0 or step == len(losses) - 1:
            print(f"step {step:3d}  loss {loss:.4f}")
    assert losses[-1] < losses[0], losses
    print(f"OK: loss {losses[0]:.4f} -> {losses[-1]:.4f} over {args.steps} "
          f"steps through ring attention at W={args.world} "
          f"({args.device})")


if __name__ == "__main__":
    main()
