"""starcoder2-3b — dense GQA (kv=2), RoPE, layernorm+gelu.
[arXiv:2402.19173; hf]  30L d_model=3072 24H kv=2 d_ff=12288 vocab=49152."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    microbatches=1,
    train_sharding="pure_fsdp",
    name="starcoder2-3b",
    family="dense",
    vocab_size=49_152,
    d_model=3072,
    n_layers=30,
    n_heads=24,
    n_kv_heads=2,
    head_dim=128,
    d_ff=12_288,
    norm="layernorm",
    act="gelu",
    qkv_bias=True,
    rope_theta=100_000.0,
)
