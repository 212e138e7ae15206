from .pipeline import DataConfig, batch_at, iterate  # noqa: F401
