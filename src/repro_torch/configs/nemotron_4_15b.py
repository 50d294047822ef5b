"""nemotron-4-15b [dense] — GQA, squared-ReLU [arXiv:2402.16819; unverified].

32L d_model=6144 48H (GQA kv=8) d_ff=24576 vocab=256000.
"""

from repro_torch.models.config import ModelConfig

FULL = ModelConfig(
    name="nemotron-4-15b",
    n_layers=32,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=24576,
    vocab=256000,
    act="squared_relu",
)

SMOKE = FULL.with_(
    name="nemotron-4-smoke",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_head=16,
    d_ff=128,
    vocab=128,
    act="squared_relu",
    chunk=16,
    loss_chunk=16,
    dtype="float32",
)
