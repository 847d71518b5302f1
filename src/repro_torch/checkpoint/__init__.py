from repro_torch.checkpoint.manager import CheckpointManager, install_sigterm_handler

__all__ = ["CheckpointManager", "install_sigterm_handler"]
