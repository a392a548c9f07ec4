"""TRUE NEGATIVE: device-claiming-import — the import-safe ways for a
module of the port's telemetry/ to know about torch without loading it."""
import sys
from typing import TYPE_CHECKING

if TYPE_CHECKING:
    import torch  # annotations only; never executes at runtime


def torch_version() -> str:
    # Package metadata, not an import.
    from importlib.metadata import version

    return version("torch")


def loaded_torch() -> "torch | None":
    # The module of a process that loaded it already, if any.
    return sys.modules.get("torch")
