"""musicgen-large [audio] — decoder-only over EnCodec tokens
[arXiv:2306.05284; hf].

48L d_model=2048 32H (GQA kv=32 = MHA) d_ff=8192 vocab=2048.  The EnCodec
frontend is a STUB: ``input_specs`` provides precomputed frame embeddings
(B, S, d_model); the backbone predicts codebook tokens (vocab 2048).
"""

from repro_torch.models.config import ModelConfig

FULL = ModelConfig(
    name="musicgen-large",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab=2048,
    act="gelu",
    frontend="embed_stub",
)

SMOKE = FULL.with_(
    name="musicgen-smoke",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_head=16,
    d_ff=128,
    vocab=64,
    chunk=16,
    loss_chunk=16,
    dtype="float32",
)
