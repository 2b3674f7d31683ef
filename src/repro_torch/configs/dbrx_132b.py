"""dbrx-132b — fine-grained MoE, 16 experts top-4, every layer.
[hf:databricks/dbrx-base; unverified]  40L d_model=6144 48H kv=8
expert d_ff=10752 vocab=100352."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    microbatches=2,
    seq_sharded_residuals=True,
    serve_fsdp=True,
    name="dbrx-132b",
    family="moe",
    vocab_size=100_352,
    d_model=6144,
    n_layers=40,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=0,  # every FFN is MoE
    n_experts=16,
    moe_top_k=4,
    moe_d_ff=10_752,
    moe_layer_period=1,
    rope_theta=500_000.0,
)
