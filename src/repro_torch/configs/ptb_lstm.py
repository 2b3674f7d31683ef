"""The paper's own PTB model: Zaremba et al. "medium regularized LSTM" with
200 units per layer (paper §4.1.1) and per-example kernel sampling."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="ptb-lstm",
    family="lstm",
    vocab_size=10_000,
    d_model=200,
    n_layers=2,
    lstm_layers=2,
    lstm_units=200,
    sampler="block-quadratic",
    sampler_block=128,
    sampler_proj_rank=None,
    m_negatives=128,
    abs_softmax=True,
    dtype="float32",
    param_dtype="float32",
    remat=False,
)
