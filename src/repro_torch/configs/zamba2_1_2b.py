"""zamba2-1.2b [hybrid] — Mamba2 + shared attn blocks [arXiv:2411.15242; hf].

38L d_model=2048 32H (GQA kv=32) d_ff=8192 vocab=32000, ssm_state=64.
Zamba2 design: a Mamba-2 backbone with ONE shared attention(+MLP) block
interleaved periodically (weights shared across its occurrences).  Here:
pattern of 19 layers = 18 mamba2 + 1 shared_attn, repeated twice.
"""

from repro_torch.models.config import ModelConfig

FULL = ModelConfig(
    name="zamba2-1.2b",
    n_layers=38,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab=32000,
    block_pattern=("mamba2",) * 18 + ("shared_attn",),
    ssm_state=64,
    rope_theta=10000.0,
)

SMOKE = FULL.with_(
    name="zamba2-smoke",
    n_layers=8,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_head=16,
    d_ff=128,
    vocab=128,
    block_pattern=("mamba2", "mamba2", "mamba2", "shared_attn"),
    ssm_state=16,
    chunk=16,
    loss_chunk=16,
    dtype="float32",
)
