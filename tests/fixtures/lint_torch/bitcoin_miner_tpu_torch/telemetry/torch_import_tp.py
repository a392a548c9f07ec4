"""TRUE POSITIVE: device-claiming-import — a module of the port's
telemetry/ (import-safe by where it lives) importing torch, at module
level and lazily: either loads torch into every host tool that reads it.
Each line the rule must flag ends in ``# expect``."""
import torch  # expect


def version() -> str:
    return torch.__version__


def profiled(name: str):
    from torch.profiler import record_function  # expect

    return record_function(name)
