"""AdamW, learning-rate schedules and int8 error-feedback gradient
compression: the port of ``repro.optim`` in plain torch."""
from . import adamw, grad_compress, schedule

__all__ = ["adamw", "grad_compress", "schedule"]
