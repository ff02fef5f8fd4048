from repro_torch.models.build import Model

__all__ = ["Model"]
