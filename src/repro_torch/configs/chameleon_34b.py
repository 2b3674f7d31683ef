"""chameleon-34b — early-fusion VLM; VQ image tokens live in the joint
65k vocab, so the backbone is a dense LM (frontend stub = token ids) with
qk-norm.  [arXiv:2405.09818; unverified]
48L d_model=8192 64H kv=8 d_ff=22016 vocab=65536."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    microbatches=1,
    train_sharding="pure_fsdp",
    name="chameleon-34b",
    family="dense",
    vocab_size=65_536,
    d_model=8192,
    n_layers=48,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=22_016,
    qk_norm=True,
    rope_theta=10_000.0,
)
