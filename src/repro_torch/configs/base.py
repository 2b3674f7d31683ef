"""Unified architecture config — an exact copy of ``repro.configs.base``'s
``ArchConfig`` fields, derived properties and ``reduced()``.

``validate()`` checks names against the port's own registries (sampler,
estimator, head impl) and the knob ranges; the family-specific checks of
unported samplers (rff, tapas, midx) and the sharding modes join with
their slices.
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | encdec | lstm | recsys
    vocab_size: int
    d_model: int
    n_layers: int

    # attention
    n_heads: int = 0
    n_kv_heads: int = 0
    head_dim: int = 0  # 0 -> d_model // n_heads
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 10_000.0
    attn_chunk: int = 512  # kv-chunk for online-softmax attention

    # ffn
    d_ff: int = 0
    act: str = "silu"  # silu (-> SwiGLU) | gelu (-> plain MLP)
    norm: str = "rmsnorm"  # rmsnorm | layernorm

    # embeddings
    tie_embeddings: bool = False
    learned_pos: bool = False  # whisper-style learned positions

    # MoE
    n_experts: int = 0
    n_shared_experts: int = 0
    moe_top_k: int = 0
    moe_d_ff: int = 0
    moe_layer_period: int = 1  # 1 = every layer, 2 = every other (jamba)
    first_dense_layers: int = 0  # deepseek: 3 leading dense layers
    capacity_factor: float = 1.25
    router_scale: bool = False  # deepseek: sigmoid+bias-free scoring

    # MLA (deepseek)
    mla: bool = False
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_dim: int = 0
    qk_rope_dim: int = 0
    v_head_dim: int = 0
    mtp: bool = False  # multi-token-prediction auxiliary head

    # SSM (mamba-1)
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_dt_rank: int = 0  # 0 -> ceil(d_model / 16)
    attn_layer_period: int = 0  # hybrid: one attn layer per period
    attn_layer_offset: int = 0

    # encoder-decoder
    n_enc_layers: int = 0
    n_dec_layers: int = 0

    # recsys tower
    history_len: int = 0
    user_feature_dim: int = 0
    tower_dims: tuple[int, ...] = ()

    # lstm
    lstm_layers: int = 0
    lstm_units: int = 0

    # paper technique (output layer)
    sampler: str = "block-quadratic-shared"
    m_negatives: int = 2048
    sampler_block: int = 512
    sampler_proj_rank: Optional[int] = 64
    sampler_alpha: float = 100.0
    sampler_refresh_every: int = 1
    # Refresh-island scheduling (DESIGN.md §7): "sync" rebuilds sampler
    # stats inside the jitted step on the cadence (bit-identical legacy
    # path); "overlap" dispatches the rebuild as an async island from a
    # head snapshot and swaps the result in refresh_stale_steps steps
    # stale, hiding the rebuild behind the step stream.
    refresh_mode: str = "sync"
    refresh_stale_steps: int = 1
    abs_softmax: bool = False
    # rff sampler family (sampler="rff"; DESIGN.md §2.7): feature dim D of
    # the positive random-feature map and the exp-kernel temperature tau.
    # rff ignores sampler_proj_rank — omega: (D, d) IS its projection.
    rff_dim: int = 128
    rff_tau: float = 1.0
    # tapas two-pass sampler (sampler="tapas"; DESIGN.md §2.8): pass-1 pool
    # size P, pass-1 base family (any single-stage sampler; it reads its own
    # knobs — sampler_block/alpha/proj_rank/rff_* — from this same config),
    # and the pass-2 resample temperature (q2 ∝ exp(o / tapas_tau) / pi).
    tapas_pool: int = 1024
    tapas_base: str = "block-quadratic-shared"
    tapas_tau: float = 1.0
    # midx quantized inverted multi-index (sampler="midx"; DESIGN.md §2.9):
    # number of codebooks (2 = coarse + residual product quantization,
    # 1 = coarse only), codewords per codebook, and the row-payload width
    # of the SERVING export (serve/quantized_index.py): 8 -> int8 rows with
    # per-row scales, 32 -> fp32 rows.  Training-side sampling always
    # scores stage 2 in fp32 — midx_bits shapes the shipped index only.
    # Posting-list size rides the shared sampler_block knob.
    midx_codebooks: int = 2
    midx_codewords: int = 16
    midx_bits: int = 8
    # loss estimator over the sampled negatives (core/estimators.py,
    # DESIGN.md §6): "sampled-softmax" (the paper's eq. 2/3 — default),
    # "nce", "sampled-logistic", or "full" (dense oracle; no sampling).
    estimator: str = "sampled-softmax"
    # loss-head implementation (DESIGN.md §4): "auto" routes per-example
    # negatives through the fused Pallas head (chunked fallback off-TPU);
    # "einsum" keeps the dense oracle path; "pallas"/"chunked" force a path.
    head_impl: str = "auto"

    # parallelism (DESIGN.md §7 + EXPERIMENTS.md §Perf)
    train_sharding: str = "tp_fsdp"  # tp_fsdp | pure_fsdp | tp
    serve_fsdp: bool = False  # gather FSDP params at inference (132B/671B)
    seq_sharded_residuals: bool = False  # S-shard residual stream (tp_fsdp)

    # numerics / memory
    microbatches: int = 1  # gradient-accumulation splits of the global batch
    dtype: str = "bfloat16"
    param_dtype: str = "bfloat16"
    remat: bool = True
    scan_layers: bool = True

    # ---- validation ---------------------------------------------------------
    HEAD_IMPLS = ("auto", "fused", "pallas", "chunked", "einsum")

    def validate(self, tp: int = 1) -> "ArchConfig":
        """Fail fast on unknown names / inconsistent head knobs, at the
        construction seams (``make_train_step``), with the list of choices.
        A sampler the reference registers but the port does not have yet
        raises ``NotImplementedError``.  Returns self."""
        # Lazy imports: configs sit below core in the layering.
        from repro_torch.core.estimators import (
            estimator_names,
            make_estimator,
        )
        from repro_torch.core.samplers import sampler_from_config

        def bad(msg: str):
            raise ValueError(f"ArchConfig '{self.name}': {msg}")

        try:
            smp = sampler_from_config(self)
        except (KeyError, ValueError) as e:
            bad(str(e.args[0] if e.args else e))
        if self.estimator not in estimator_names():
            bad(f"unknown estimator '{self.estimator}'; "
                f"have {estimator_names()}")
        if self.head_impl not in self.HEAD_IMPLS:
            bad(f"unknown head_impl '{self.head_impl}'; "
                f"have {list(self.HEAD_IMPLS)}")
        if self.midx_bits not in (8, 32):
            bad(f"midx_bits must be 8 (int8 rows) or 32 (fp32 rows), got "
                f"{self.midx_bits}")
        samples = make_estimator(self.estimator).needs_sampling
        if samples and not smp.supports_head_loss():
            bad(f"sampler '{self.sampler}' cannot drive the head loss")
        if samples and self.m_negatives <= 0:
            bad(f"m_negatives must be positive, got {self.m_negatives}")
        if self.sampler_block <= 0:
            bad(f"sampler_block must be positive, got {self.sampler_block}")
        if self.sampler_refresh_every <= 0:
            bad("sampler_refresh_every must be >= 1, got "
                f"{self.sampler_refresh_every}")
        if self.refresh_mode not in ("sync", "overlap"):
            bad(f"unknown refresh_mode '{self.refresh_mode}'; "
                "have ['sync', 'overlap']")
        if self.refresh_stale_steps < 1:
            bad("refresh_stale_steps must be >= 1, got "
                f"{self.refresh_stale_steps}")
        if (self.refresh_mode == "overlap"
                and self.refresh_stale_steps >= self.sampler_refresh_every
                and self.sampler_refresh_every > 1):
            bad(f"refresh_stale_steps={self.refresh_stale_steps} must be < "
                f"sampler_refresh_every={self.sampler_refresh_every} in "
                "overlap mode: a rebuild must land before the next one "
                "dispatches")
        if samples and tp > 1 and self.m_negatives % tp:
            bad(f"m_negatives={self.m_negatives} must divide by the "
                f"vocab-parallel degree tp={tp}")
        if self.microbatches < 1:
            bad(f"microbatches must be >= 1, got {self.microbatches}")
        return self

    # ---- derived -----------------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // max(self.n_heads, 1)

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def dt_rank(self) -> int:
        return self.ssm_dt_rank or -(-self.d_model // 16)

    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    def supports_long_context(self) -> bool:
        """True when 500k-token decode is in-contract (sub-quadratic state)."""
        return self.family in ("ssm", "hybrid")

    def layer_kinds(self) -> list[str]:
        """Per-layer mixer/ffn plan, e.g. ['mamba+moe', 'attn+mlp', ...]."""
        kinds = []
        for i in range(self.n_layers):
            if self.family == "ssm":
                mixer = "mamba"
            elif self.family == "hybrid":
                in_period = (i % self.attn_layer_period) == self.attn_layer_offset
                mixer = "attn" if in_period else "mamba"
            else:
                mixer = "attn"
            if self.n_experts and i >= self.first_dense_layers and (
                    i % self.moe_layer_period == self.moe_layer_period - 1
                    or self.moe_layer_period == 1):
                ffn = "moe"
            elif self.d_ff:
                ffn = "mlp"
            else:
                ffn = "none"
            kinds.append(f"{mixer}+{ffn}")
        return kinds

    def reduced(self, **overrides) -> "ArchConfig":
        """Tiny same-wiring variant for CPU smoke tests."""
        changes: dict = dict(
            name=self.name + "-smoke",
            microbatches=1,
            train_sharding="tp_fsdp",
            seq_sharded_residuals=False,
            vocab_size=min(self.vocab_size, 512),
            d_model=64,
            n_layers=min(self.n_layers, 4),
            dtype="float32",
            param_dtype="float32",
            m_negatives=32,
            sampler_block=32,
            sampler_proj_rank=None,
            rff_dim=64,
            tapas_pool=128,
            midx_codewords=8,
            remat=False,
        )
        if self.n_heads:
            changes.update(n_heads=4, n_kv_heads=min(self.n_kv_heads, 2) or 2,
                           head_dim=16)
        if self.d_ff:
            changes.update(d_ff=128)
        if self.n_experts:
            changes.update(n_experts=4, moe_top_k=min(self.moe_top_k, 2),
                           moe_d_ff=64,
                           n_shared_experts=min(self.n_shared_experts, 1),
                           first_dense_layers=min(self.first_dense_layers, 1))
        if self.mla:
            changes.update(q_lora_rank=32, kv_lora_rank=32, qk_nope_dim=16,
                           qk_rope_dim=8, v_head_dim=16, head_dim=0)
        if self.ssm_state:
            changes.update(ssm_state=8, ssm_dt_rank=8)
        if self.attn_layer_period:
            changes.update(n_layers=max(self.attn_layer_period, 4))
        if self.n_enc_layers:
            changes.update(n_enc_layers=2, n_dec_layers=2, n_layers=4)
        if self.tower_dims:
            changes.update(tower_dims=(64, 64))
        if self.lstm_layers:
            changes.update(lstm_units=32)
        changes.update(overrides)
        return dataclasses.replace(self, **changes)
