"""llama4-maverick-400b-a17b [moe] — MoE, early fusion
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified].

48L d_model=5120 40H (GQA kv=8) d_ff=8192 vocab=202048, MoE 128e top-1.
The early-fusion multimodal frontend is out of the LM backbone scope
(per the assignment the backbone only is modelled); every layer routes
top-1 over 128 experts of d_ff=8192.
"""

from repro_torch.models.config import ModelConfig

FULL = ModelConfig(
    name="llama4-maverick-400b-a17b",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=0,
    vocab=202048,
    moe_experts=128,
    moe_top_k=1,
    moe_d_ff=8192,
    block_pattern=("attn",),
)

SMOKE = FULL.with_(
    name="llama4-maverick-smoke",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_head=16,
    vocab=128,
    moe_experts=8,
    moe_top_k=1,
    moe_d_ff=32,
    chunk=16,
    loss_chunk=16,
    dtype="float32",
)
