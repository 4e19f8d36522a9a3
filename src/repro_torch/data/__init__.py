from repro_torch.data.pipeline import make_batch, tokens

__all__ = ["make_batch", "tokens"]
