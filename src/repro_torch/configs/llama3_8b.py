"""llama3-8b — dense GQA, 128k vocab.  [arXiv:2407.21783; unverified]
32L d_model=4096 32H kv=8 d_ff=14336 vocab=128256."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    microbatches=1,
    train_sharding="pure_fsdp",
    name="llama3-8b",
    family="dense",
    vocab_size=128_256,
    d_model=4096,
    n_layers=32,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14_336,
    rope_theta=500_000.0,
)
