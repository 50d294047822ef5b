"""xlstm-350m [ssm] — sLSTM + mLSTM blocks [arXiv:2405.04517; unverified].

24L d_model=1024 4H (GQA kv=4) d_ff=0 vocab=50304.  Block ratio follows
the paper's xLSTM[7:1]: seven mLSTM blocks per sLSTM block (period 8,
3 repeats).  d_ff=0: xLSTM blocks carry no separate FFN (the mLSTM
up/down projections play that role).
"""

from repro_torch.models.config import ModelConfig

FULL = ModelConfig(
    name="xlstm-350m",
    n_layers=24,
    d_model=1024,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab=50304,
    block_pattern=("mlstm",) * 7 + ("slstm",),
    chunk=256,
    rope_theta=10000.0,
)

SMOKE = FULL.with_(
    name="xlstm-350m-smoke",
    n_layers=8,
    d_model=64,
    vocab=128,
    chunk=16,
    loss_chunk=16,
    dtype="float32",
)
