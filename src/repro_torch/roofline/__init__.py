"""The model side of the roofline (``repro.roofline``'s ``count_params``
and ``model_flops``)."""
from repro_torch.roofline.analysis import count_params, model_flops

__all__ = ["count_params", "model_flops"]
