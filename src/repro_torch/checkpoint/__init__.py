from repro_torch.checkpoint.npz import latest_checkpoint, restore, save

__all__ = ["save", "restore", "latest_checkpoint"]
