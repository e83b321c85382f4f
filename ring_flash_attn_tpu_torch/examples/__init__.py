"""Runnable examples of the port: ``serve_continuous_batching`` and
``train_hf_ring`` (``python -m ring_flash_attn_tpu_torch.examples.<name>
--help``)."""
