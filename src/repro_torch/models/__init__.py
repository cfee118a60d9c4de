"""The decoder LM's forward pass, loss and parameter declarations (``lm``;
dense, MoE, Mamba-2 and hybrid slots in ``blocks``), behind the ``Model``
facade (``model``)."""

from repro_torch.models.model import Model, build_model

__all__ = ["Model", "build_model"]
