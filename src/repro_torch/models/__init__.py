"""The LMs of the port: config, shape cells, layers, and the layer-looped LM."""

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
    decoder-only :class:`~repro_torch.models.lm.LM`. The encoder-decoder
    family is not ported yet."""
    if cfg.family == "encdec":
        raise NotImplementedError(
            f"{cfg.name}: the encoder-decoder family (models/encdec.py) is not ported yet "
            "(ROADMAP A7)"
        )
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
