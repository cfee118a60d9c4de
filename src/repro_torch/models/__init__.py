"""The dense decoder's forward pass, loss and parameter declarations
(``lm``), behind the ``Model`` facade (``model``)."""

from repro_torch.models.model import Model, build_model

__all__ = ["Model", "build_model"]
