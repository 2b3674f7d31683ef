"""qwen2-72b — dense GQA with QKV bias.  [arXiv:2407.10671; hf]
80L d_model=8192 64H kv=8 d_ff=29568 vocab=152064."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    microbatches=1,
    train_sharding="pure_fsdp",
    name="qwen2-72b",
    family="dense",
    vocab_size=152_064,
    d_model=8192,
    n_layers=80,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=29_568,
    qkv_bias=True,
    rope_theta=1_000_000.0,
)
