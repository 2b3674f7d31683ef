"""deepseek-v3-671b — MLA + fine-grained MoE (1 shared + 256 routed, top-8)
+ multi-token prediction.  [arXiv:2412.19437; hf]
61L d_model=7168 128H vocab=129280 expert d_ff=2048 (first 3 layers dense,
d_ff=18432 per the released config)."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    microbatches=2,
    seq_sharded_residuals=True,
    serve_fsdp=True,
    name="deepseek-v3-671b",
    family="moe",
    vocab_size=129_280,
    d_model=7168,
    n_layers=61,
    n_heads=128,
    n_kv_heads=128,
    d_ff=18_432,  # the 3 leading dense layers
    n_experts=256,
    n_shared_experts=1,
    moe_top_k=8,
    moe_d_ff=2048,
    moe_layer_period=1,
    first_dense_layers=3,
    router_scale=True,
    mla=True,
    q_lora_rank=1536,
    kv_lora_rank=512,
    qk_nope_dim=128,
    qk_rope_dim=64,
    v_head_dim=128,
    mtp=True,
    rope_theta=10_000.0,
    capacity_factor=1.25,
)
