"""jamba-v0.1-52b — hybrid Mamba+attention (1:7 interleave) with MoE every
other layer (16 experts top-2).  [arXiv:2403.19887; hf]
32L d_model=4096 32H kv=8 d_ff=14336 vocab=65536 state=16."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    microbatches=8,
    seq_sharded_residuals=True,
    name="jamba-v0.1-52b",
    family="hybrid",
    vocab_size=65_536,
    d_model=4096,
    n_layers=32,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14_336,
    n_experts=16,
    moe_top_k=2,
    moe_d_ff=14_336,
    moe_layer_period=2,
    ssm_state=16,
    ssm_conv=4,
    ssm_expand=2,
    attn_layer_period=8,
    attn_layer_offset=4,
    rope_theta=0.0,  # jamba uses no positional encoding in attn layers
)
