"""The LM side of the port (``repro.models``): every family's models in
plain torch (decoder-only ``LM`` and the encoder-decoder ``Seq2Seq``),
held against the reference's values."""
from repro_torch.models.common import ModelConfig, ParamSpec
from repro_torch.models.model import LM, Seq2Seq, build_model

__all__ = ["ModelConfig", "ParamSpec", "LM", "Seq2Seq", "build_model"]
