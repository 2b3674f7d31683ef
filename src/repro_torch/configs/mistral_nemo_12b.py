"""mistral-nemo-12b — dense GQA, 128k context, head_dim 128 (< d/H).
[hf:mistralai/Mistral-Nemo-Base-2407; hf]  40L d_model=5120 32H kv=8
d_ff=14336 vocab=131072."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    microbatches=1,
    train_sharding="pure_fsdp",
    name="mistral-nemo-12b",
    family="dense",
    vocab_size=131_072,
    d_model=5120,
    n_layers=40,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14_336,
    rope_theta=1_000_000.0,
)
