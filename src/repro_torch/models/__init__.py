"""The LM side of the port (``repro.models``): decoder-only models in
plain torch, held against the reference's values."""
from repro_torch.models.common import ModelConfig, ParamSpec
from repro_torch.models.model import LM, Seq2Seq, build_model

__all__ = ["ModelConfig", "ParamSpec", "LM", "Seq2Seq", "build_model"]
