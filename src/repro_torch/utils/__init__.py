"""Small utilities of the port (``repro_torch.utils.logging.get_logger``)."""
