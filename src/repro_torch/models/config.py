"""Model configuration, field for field the JAX package's ``ModelConfig``
(src/repro/models/config.py), so configs carry across unchanged.

``attn_impl``: ``"pallas"`` is the hand-written kernel for a CUDA tensor
and its plain version for a CPU tensor (dispatch by device, as every
kernel of the port); ``"ref"`` the plain version everywhere;
``"chunked"`` the plain q-blocked attention of ``attention_xla``.
``remat`` is honoured in training: with grad enabled each block runs
under ``torch.utils.checkpoint``.  ``seq_shard`` places the residual
entering each repeat of the block pattern over the sequence
(``logical(x, "batch", "seq", None)``), which matters only under a mesh
(``repro_torch.dist.sharding``).  ``scan_layers`` is a JAX execution knob,
kept so configs compare equal, and ignored: the port loops over layers
in Python.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    d_head: int = 0                   # 0 -> d_model // n_heads

    # activation / FFN
    act: str = "swiglu"               # swiglu | gelu | squared_relu

    # MoE (0 experts = dense)
    moe_experts: int = 0
    moe_top_k: int = 0
    moe_d_ff: int = 0
    moe_capacity_factor: float = 1.25

    # layer pattern, cycled to n_layers: attn | cross_attn | mamba2 |
    # mlstm | slstm | shared_attn
    block_pattern: Tuple[str, ...] = ("attn",)

    # sequence-mixer extras
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    chunk: int = 256

    # modality frontend: "none" = token ids; "embed_stub" = precomputed
    # frame/patch embeddings are the input
    frontend: str = "none"
    n_patches: int = 0

    rope_theta: float = 500000.0
    norm_eps: float = 1e-5
    dtype: str = "bfloat16"

    # execution knobs
    attn_impl: str = "chunked"        # chunked | ref | pallas
    attn_block_q: int = 512           # q-block of the chunked attention
    seq_shard: bool = True            # the residual's seq placement
    remat: bool = True                # checkpoint each block in training
    loss_chunk: int = 1024
    scan_layers: bool = True          # JAX only: ignored

    # LGD integration (data-pipeline-level adaptive sampling)
    lgd_enabled: bool = False
    lgd_k: int = 7
    lgd_l: int = 10
    lgd_refresh_every: int = 200

    def __post_init__(self):
        if self.d_head == 0:
            object.__setattr__(self, "d_head", self.d_model // self.n_heads)
        if self.n_heads % self.n_kv_heads != 0:
            raise ValueError(f"{self.name}: n_heads={self.n_heads} not a "
                             f"multiple of n_kv_heads={self.n_kv_heads}")
        if self.n_layers % len(self.block_pattern) != 0:
            raise ValueError(
                f"{self.name}: n_layers={self.n_layers} not a multiple of "
                f"pattern length {len(self.block_pattern)}")

    @property
    def repeats(self) -> int:
        return self.n_layers // len(self.block_pattern)

    @property
    def is_moe(self) -> bool:
        return self.moe_experts > 0

    @property
    def is_attention_free(self) -> bool:
        return all(b in ("mamba2", "mlstm", "slstm")
                   for b in self.block_pattern)

    @property
    def has_ssm(self) -> bool:
        return any(b in ("mamba2", "mlstm", "slstm")
                   for b in self.block_pattern)

    @property
    def supports_long_context(self) -> bool:
        """Sub-quadratic archs: SSM/hybrid/linear-attn run long_500k."""
        return self.has_ssm

    def with_(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)
