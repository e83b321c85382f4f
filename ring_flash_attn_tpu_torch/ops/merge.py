"""Online-softmax merge of partial attention results.

The port of ``ring_flash_attn_tpu/ops/merge.py``: combine two normalized
partials (out_a, lse_a), (out_b, lse_b) into the partial for the union of
their KV sets, in fp32:

    out = out_a - sigmoid(lse_b - lse_a) * (out_a - out_b)
    lse = max(lse_a, lse_b) + log1p(exp(-|lse_a - lse_b|))

The max/log1p form of log(e^a + e^b) is exact in every regime, where
``a - logsigmoid(a - b)`` cancels catastrophically when a is the NEG_INF
sentinel of a dead partial and b is finite. A dead partial has
lse = -1e30, so sigmoid and exp underflow to exactly 0 and the merge leaves
the other side unchanged: no NaNs, no special cases.
"""

import torch


def merge_partials(out, lse, block_out, block_lse):
    """Merge (block_out, block_lse) into accumulator (out, lse), all fp32.

    out: (B, H, S, D) f32; lse: (B, H, S) f32. If out is None the block
    initializes the accumulator."""
    if out is None:
        return block_out.float(), block_lse.float()
    w = torch.sigmoid(block_lse - lse)[..., None]
    new_out = out - w * (out - block_out)
    new_lse = torch.maximum(lse, block_lse) + torch.log1p(
        torch.exp(-(lse - block_lse).abs()))
    return new_out, new_lse
