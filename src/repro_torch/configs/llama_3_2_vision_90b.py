"""llama-3.2-vision-90b [vlm] — cross-attn image layers
[hf:meta-llama/Llama-3.2-11B-Vision; unverified].

100L d_model=8192 64H (GQA kv=8) d_ff=28672 vocab=128256.  Every 5th
layer cross-attends to image patch embeddings; the vision encoder is a
STUB (``input_specs`` provides precomputed patch embeddings, n_patches
= 1024 ~ one 1600-patch tile pooled).
"""

from repro_torch.models.config import ModelConfig

FULL = ModelConfig(
    name="llama-3.2-vision-90b",
    n_layers=100,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=28672,
    vocab=128256,
    act="swiglu",
    block_pattern=("attn", "attn", "attn", "attn", "cross_attn"),
    n_patches=1024,
)

SMOKE = FULL.with_(
    name="llama-vision-smoke",
    n_layers=5,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_head=16,
    d_ff=128,
    vocab=128,
    n_patches=8,
    chunk=16,
    loss_chunk=16,
    dtype="float32",
)
