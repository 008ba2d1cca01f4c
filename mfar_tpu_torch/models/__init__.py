"""The port's encoder family: the BERT/Contriever encoder.  T5/GTR encoders
are ROADMAP A14."""

from mfar_tpu_torch.models.encoder import Encoder, EncoderConfig


def build_encoder(config) -> Encoder:
    """The encoder module for a config (``mfar_tpu.models.build_encoder``);
    load its weights with ``load_state_dict``."""
    _check_bert(config)
    return Encoder(config)


def encoder_dim(config) -> int:
    """Sentence-embedding width of an encoder config."""
    _check_bert(config)
    return config.hidden_size


def _check_bert(config) -> None:
    if not isinstance(config, EncoderConfig):
        raise NotImplementedError(
            f"{type(config).__name__}: the port has the BERT encoder only; the "
            f"T5/GTR family is ROADMAP A14"
        )


__all__ = ["Encoder", "EncoderConfig", "build_encoder", "encoder_dim"]
