"""whisper-large-v3 — encoder-decoder; the conv / mel frontend is a stub
(precomputed frame embeddings go to the encoder).  [arXiv:2212.04356]
32+32L d_model=1280 20H kv=20 d_ff=5120 vocab=51866, LayerNorm, GELU,
learned positions."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    microbatches=1,
    train_sharding="pure_fsdp",
    name="whisper-large-v3",
    family="encdec",
    vocab_size=51_866,
    d_model=1280,
    n_layers=64,
    n_enc_layers=32,
    n_dec_layers=32,
    n_heads=20,
    n_kv_heads=20,
    head_dim=64,
    d_ff=5120,
    norm="layernorm",
    act="gelu",
    learned_pos=True,
)
