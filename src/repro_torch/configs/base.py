"""Config dataclasses + registry for architectures, input shapes, and the
paper-technique (wireless SL/FL/CL) knobs — the port of
`repro/configs/base.py` with torch dtypes in place of jnp ones."""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

_REGISTRY: dict[str, "ArchConfig"] = {}


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                  # dense | moe | ssm | hybrid | vlm | audio | tiny
    citation: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0            # 0 -> d_model // n_heads
    # MoE
    n_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    capacity_factor: float = 1.25
    shared_expert: bool = False
    moe_chunk: int = 0
    # SSM / hybrid
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    attn_every: int = 0
    slstm_every: int = 0
    # attention flavour
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    rope_fraction: float = 1.0
    norm: str = "rmsnorm"        # rmsnorm | layernorm
    parallel_block: bool = False
    # long context
    sliding_window: int = 0
    # enc-dec
    enc_layers: int = 0
    # multimodal frontends
    frontend: str = ""
    n_frontend_tokens: int = 0
    # numerics
    dtype: Any = torch.bfloat16
    param_dtype: Any = torch.float32
    microbatch_size: int = 0
    remat: bool = True
    # attention chunking for train/prefill (memory-bounded softmax)
    attn_chunk: int = 512

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def expert_ff(self) -> int:
        return self.moe_d_ff or self.d_ff

    def reduced(self) -> "ArchConfig":
        """Smoke-test variant: <=2 layers, d_model<=512, <=4 experts."""
        d = min(self.d_model, 256)
        heads = min(self.n_heads, 4)
        kv = min(self.n_kv_heads, heads)
        return dataclasses.replace(
            self,
            n_layers=2, d_model=d, n_heads=heads, n_kv_heads=kv,
            head_dim=d // heads,
            d_ff=min(self.d_ff, 512) if self.d_ff else 0,
            moe_d_ff=min(self.moe_d_ff, 256) if self.moe_d_ff else 0,
            vocab_size=min(self.vocab_size, 1024),
            n_experts=min(self.n_experts, 4) if self.n_experts else 0,
            top_k=min(self.top_k, 2) if self.top_k else 0,
            attn_every=min(self.attn_every, 1) if self.attn_every else 0,
            slstm_every=min(self.slstm_every, 2) if self.slstm_every else 0,
            enc_layers=2 if self.enc_layers else 0,
            n_frontend_tokens=min(self.n_frontend_tokens, 16) if self.n_frontend_tokens else 0,
            ssm_state=min(self.ssm_state, 16) if self.ssm_state else 0,
            ssm_head_dim=min(self.ssm_head_dim, 32),
            attn_chunk=64,
            dtype=torch.float32,
        )


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                    # train | prefill | decode
    microbatch: int = 0


# the JAX package's input shapes (the dry run's)
SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


@dataclasses.dataclass(frozen=True)
class WirelessConfig:
    """Paper Table I knobs; field for field the JAX package's
    `WirelessConfig` (see its docstrings for the beyond-paper knobs)."""
    mode: str = "cl"             # cl | fl | sl
    snr_db: float = 20.0
    fading: bool = True
    quant_bits: int = 8
    split_layer: int = 2
    compress_factor: int = 4
    grad_clip: float = 0.5
    local_steps: int = 5
    n_users: int = 3
    comm_cycles: int = 7
    bandwidth_hz: float = 100e3
    tx_power_w: float = 1e-3
    perfect_channel: bool = False
    arq_attempts: int = 1
    arq_min_f2: float = 0.25
    arq_max_tx: int = 0
    ge_p_gb: float = 0.0
    ge_p_bg: float = 0.5
    arq_backoff_s: float = 0.0
    rounding: str = "nearest"
    aggregate: str = "mean"
    sync: str = "barrier"
    wire_dtype: str = "float32"
    use_kernel: bool = False


def register(cfg: ArchConfig) -> ArchConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_arch(name: str) -> ArchConfig:
    import repro_torch.configs  # noqa: F401  (populates registry)
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; the registered archs are "
                       f"{sorted(_REGISTRY)} (ROADMAP.md lists what the "
                       f"port runs of each)")
    return _REGISTRY[name]


def list_archs() -> list[str]:
    import repro_torch.configs  # noqa: F401
    return sorted(_REGISTRY)
