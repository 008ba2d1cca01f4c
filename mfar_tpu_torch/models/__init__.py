"""The port's encoder families: BERT/Contriever (:mod:`.encoder`) and
T5/GTR (:mod:`.t5_encoder`), dispatched on the config type as
``mfar_tpu.models`` does."""

from mfar_tpu_torch.models import encoder as _bert
from mfar_tpu_torch.models.encoder import Encoder, EncoderConfig
from mfar_tpu_torch.models.t5_encoder import T5Config, T5Encoder, init_t5_encoder


def build_encoder(config):
    """The encoder module for a config (``mfar_tpu.models.build_encoder``);
    load its weights with ``load_state_dict``."""
    return T5Encoder(config) if isinstance(config, T5Config) else Encoder(config)


def init_encoder(config, seed: int = 0):
    """A seeded random-init encoder of either family, on the CPU."""
    if isinstance(config, T5Config):
        return init_t5_encoder(config, seed=seed)
    return _bert.init_encoder(config, seed=seed)


def encoder_dim(config) -> int:
    """Sentence-embedding width of an encoder config."""
    if isinstance(config, T5Config):
        return config.projection_dim or config.d_model
    return config.hidden_size


__all__ = ["Encoder", "EncoderConfig", "T5Config", "T5Encoder", "build_encoder",
           "encoder_dim", "init_encoder"]
