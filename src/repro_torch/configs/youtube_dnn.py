"""The paper's own YouTube retrieval model (Covington et al. 2016 style):
watch-history embeddings + user features -> MLP tower -> softmax over all
videos.  YouTube100k variant (100k classes)."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="youtube-dnn",
    family="recsys",
    vocab_size=100_000,
    d_model=64,  # watch-embedding width
    n_layers=2,
    history_len=3,
    user_feature_dim=64,
    tower_dims=(256, 128),
    sampler="block-quadratic",
    sampler_block=256,
    sampler_proj_rank=None,
    m_negatives=128,
    abs_softmax=True,
    dtype="float32",
    param_dtype="float32",
    remat=False,
)
