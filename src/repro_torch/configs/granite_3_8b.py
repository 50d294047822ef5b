"""granite-3-8b [dense] — GQA [hf:ibm-granite/granite-3.0-2b-base; hf].

40L d_model=4096 32H (GQA kv=8) d_ff=12800 vocab=49155.
"""

from repro_torch.models.config import ModelConfig

FULL = ModelConfig(
    name="granite-3-8b",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=12800,
    vocab=49155,
    act="swiglu",
)

SMOKE = FULL.with_(
    name="granite-3-smoke",
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
