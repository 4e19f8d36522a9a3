from repro_torch.optim.adamw import AdamW

__all__ = ["AdamW"]
