from repro_torch.checkpoint.io import restore_checkpoint, save_checkpoint

__all__ = ["save_checkpoint", "restore_checkpoint"]
