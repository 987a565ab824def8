from miner_tpu_torch.models.fastformer import (
    AttentionPooling,
    Fastformer,
    FastformerConfig,
    FastformerLayer,
    FastformerUserModel,
    FastSelfAttention,
)
from miner_tpu_torch.models.miner import CategoryEmbedding, Miner
from miner_tpu_torch.models.news_encoder import MoEAdaptor, NewsEncoder, NewsEncoderMoe
from miner_tpu_torch.models.plm import PLMConfig, TransformerPLM
from miner_tpu_torch.models.poly_attention import PolyAttention, TargetAwareAttention
from miner_tpu_torch.models.unbert import UNBert
from miner_tpu_torch.models.unisrec import UniSRec

__all__ = [
    "AttentionPooling",
    "CategoryEmbedding",
    "FastSelfAttention",
    "Fastformer",
    "FastformerConfig",
    "FastformerLayer",
    "FastformerUserModel",
    "Miner",
    "MoEAdaptor",
    "NewsEncoder",
    "NewsEncoderMoe",
    "PLMConfig",
    "PolyAttention",
    "TargetAwareAttention",
    "TransformerPLM",
    "UNBert",
    "UniSRec",
]
