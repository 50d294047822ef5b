"""qwen3-moe-235b-a22b [moe] — 128 experts top-8 [hf:Qwen/Qwen3-30B-A3B; hf].

94L d_model=4096 64H (GQA kv=4) expert d_ff=1536 vocab=151936,
MoE 128e top-8.  Every layer is MoE (fine-grained experts, Qwen3 style).
"""

from repro_torch.models.config import ModelConfig

FULL = ModelConfig(
    name="qwen3-moe-235b-a22b",
    n_layers=94,
    d_model=4096,
    n_heads=64,
    n_kv_heads=4,
    d_ff=0,
    vocab=151936,
    moe_experts=128,
    moe_top_k=8,
    moe_d_ff=1536,
    block_pattern=("attn",),
)

SMOKE = FULL.with_(
    name="qwen3-moe-smoke",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_head=16,
    vocab=128,
    moe_experts=8,
    moe_top_k=2,
    moe_d_ff=32,
    chunk=16,
    loss_chunk=16,
    dtype="float32",
)
