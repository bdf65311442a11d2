"""Configuration (copy of the BERT, fine-tune and pretrain parts of
``spmm_tpu.configs``).

The three architectures, with the values of the reference
config_bert.json / config_bert_property.json / config_bert_smiles.json, and
the fine-tune and pretrain hyperparameters.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class BertArchConfig:
    """Architecture of one chem-BERT stack.

    ``fusion_layer``: layers >= fusion_layer carry cross-attention and form
    the "fusion" section; layers below form the "text" section.
    ``encoder_width``: K/V projection input width of cross-attention.
    ``tie_word_embeddings``: the LM-head decoder weight IS the word
    embedding table (the reference's HF tie).
    """

    vocab_size: int = 300
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    fusion_layer: int = 6
    encoder_width: int = 768
    add_cross_attention: bool = True
    hidden_dropout_prob: float = 0.1
    attention_probs_dropout_prob: float = 0.1
    layer_norm_eps: float = 1e-12
    initializer_range: float = 0.02
    pad_token_id: int = 0
    tie_word_embeddings: bool = True

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads


def text_config() -> BertArchConfig:
    """12-layer SMILES encoder/decoder; top 6 layers are fusion (cross-attn)."""
    return BertArchConfig(
        vocab_size=300,
        num_hidden_layers=12,
        fusion_layer=6,
        add_cross_attention=True,
    )


def property_config() -> BertArchConfig:
    """6-layer property-vector encoder; no cross-attention layers (its
    one-entry word table exists but is bypassed via inputs_embeds)."""
    return BertArchConfig(
        vocab_size=1,
        num_hidden_layers=6,
        fusion_layer=6,
        add_cross_attention=False,
    )


def smiles_config() -> BertArchConfig:
    """6-layer unimodal SMILES encoder of reaction prediction (reference
    config_bert_smiles.json)."""
    return BertArchConfig(
        vocab_size=300,
        num_hidden_layers=6,
        fusion_layer=6,
        add_cross_attention=False,
    )


@dataclasses.dataclass(frozen=True)
class FinetuneConfig:
    """Downstream fine-tune hyperparameters (reference d_classification.py:198-207 etc.)."""

    lr: float = 3e-5
    min_lr: float = 5e-6
    warmup_lr: float = 0.5e-5
    weight_decay: float = 0.02
    epochs: int = 10
    warmup_epochs: int = 1
    batch_size_train: int = 16
    batch_size_test: int = 64
    max_text_len: int = 100
    step_size: int = 50           # warmup chunk size (50 for cls, 100 for reg/rxn)
    seed: Optional[int] = None


@dataclasses.dataclass(frozen=True)
class PretrainConfig:
    """SPMM pretraining hyperparameters (reference SPMM_pretrain.py:51-65),
    with the JAX package's defaults."""

    embed_dim: int = 256
    batch_size: int = 96          # per-device batch
    temp: float = 0.07
    queue_size: int = 36864
    momentum: float = 0.995
    alpha: float = 0.4
    mask_prob: float = 0.5        # Bernoulli property-masking prob (SPMM_models.py:85)
    mpm_weight: float = 5.0       # MPM loss multiplier (SPMM_models.py:256)
    max_text_len: int = 100
    n_properties: int = 53
    lr: float = 5e-5
    min_lr: float = 1e-5
    warmup_lr: float = 5e-5
    weight_decay: float = 0.02
    epochs: int = 30
    warmup_epochs: int = 20       # interpreted as warmup *chunks* of 100 steps
    grad_clip: float = 5.0
    bf16_compute: bool = False    # bf16 encoder compute (reference: fp16 AMP)
    remat: bool = False           # objective+layer rematerialization (memory for FLOPs)
    bf16_moments: bool = False    # bf16 Adam first moment (optax mu_dtype)
    zero1: bool = False           # ZeRO-1: Adam moments sharded over the ranks


@dataclasses.dataclass(frozen=True)
class LatentMoeConfig:
    """A decoder-only LM with latent attention (MLA) and routed experts, in
    DeepSeek-V3's layout (``models/latent_moe.py``); the defaults are
    Moonlight-16B-A3B's published config.json.

    ``first_k_dense_replace`` leading layers have a dense SwiGLU FFN of
    ``intermediate_size``; the rest route each token to
    ``num_experts_per_tok`` of ``n_routed_experts`` SwiGLU experts of
    ``moe_intermediate_size`` by sigmoid scores with a correction bias,
    beside ``n_shared_experts`` shared ones.  ``kv_norm_eps`` is the
    ``kv_a_layernorm``'s eps (the norm class's default; the config gives
    none)."""

    vocab_size: int = 163840
    hidden_size: int = 2048
    num_hidden_layers: int = 27
    num_attention_heads: int = 16
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    intermediate_size: int = 11264
    moe_intermediate_size: int = 1408
    n_routed_experts: int = 64
    num_experts_per_tok: int = 6
    n_shared_experts: int = 2
    first_k_dense_replace: int = 1
    routed_scaling_factor: float = 2.446
    rms_norm_eps: float = 1e-5
    kv_norm_eps: float = 1e-6
    rope_theta: float = 50000.0
    max_position_embeddings: int = 8192

    @property
    def latent_dim(self) -> int:
        """Values a token a layer in the cache: the latent and the shared
        rotated key."""
        return self.kv_lora_rank + self.qk_rope_head_dim

    @classmethod
    def from_dict(cls, d: dict) -> "LatentMoeConfig":
        """The fields of ``d`` that this class has (a config.json)."""
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in names})
