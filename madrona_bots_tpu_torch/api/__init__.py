from madrona_bots_tpu_torch.api.manager import SimManager, Tensor

__all__ = ["SimManager", "Tensor"]
