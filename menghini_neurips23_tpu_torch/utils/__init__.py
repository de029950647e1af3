from menghini_neurips23_tpu_torch.utils.logging import setup_logging  # noqa: F401
