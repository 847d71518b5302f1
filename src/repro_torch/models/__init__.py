"""The models of the port: config, shape cells, layers, the layer-looped LM and
the encoder-decoder."""

from repro_torch.models.config import (
    ALL_SHAPES,
    DECODE_32K,
    LONG_500K,
    PREFILL_32K,
    SHAPES_BY_NAME,
    TRAIN_4K,
    ModelConfig,
    ShapeConfig,
    applicable_shapes,
)


def build_model(cfg: ModelConfig):
    """The model object of a config (``repro.models.build_model``): the
    :class:`~repro_torch.models.encdec.EncDec` for the encoder-decoder
    family, the decoder-only :class:`~repro_torch.models.lm.LM` for every
    other."""
    if cfg.family == "encdec":
        from repro_torch.models.encdec import EncDec

        return EncDec(cfg)
    from repro_torch.models.lm import LM

    return LM(cfg)


__all__ = [
    "ModelConfig",
    "ShapeConfig",
    "ALL_SHAPES",
    "SHAPES_BY_NAME",
    "TRAIN_4K",
    "PREFILL_32K",
    "DECODE_32K",
    "LONG_500K",
    "applicable_shapes",
    "build_model",
]
