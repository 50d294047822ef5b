"""starcoder2-15b [dense] — GQA, RoPE [arXiv:2402.19173].

40L d_model=6144 48H (GQA kv=4) d_ff=24576 vocab=49152.  StarCoder2 uses
a plain (non-gated) GELU MLP.
"""

from repro_torch.models.config import ModelConfig

FULL = ModelConfig(
    name="starcoder2-15b",
    n_layers=40,
    d_model=6144,
    n_heads=48,
    n_kv_heads=4,
    d_ff=24576,
    vocab=49152,
    act="gelu",
)

SMOKE = FULL.with_(
    name="starcoder2-smoke",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_head=16,
    d_ff=128,
    vocab=128,
    chunk=16,
    loss_chunk=16,
    dtype="float32",
)
