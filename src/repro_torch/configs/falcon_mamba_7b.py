"""falcon-mamba-7b — pure Mamba-1 LM (attention-free).
[arXiv:2410.05355; unverified]  64L d_model=4096 d_ff=0 vocab=65024 state=16."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    microbatches=1,
    train_sharding="pure_fsdp",
    name="falcon-mamba-7b",
    family="ssm",
    vocab_size=65_024,
    d_model=4096,
    n_layers=64,
    d_ff=0,
    ssm_state=16,
    ssm_conv=4,
    ssm_expand=2,
    rope_theta=0.0,
)
