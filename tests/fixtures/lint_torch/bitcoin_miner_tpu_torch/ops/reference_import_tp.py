"""TRUE POSITIVE: device-claiming-import — a module of the port's ops/
crossing the port's boundary: the JAX package at module level, and jax
lazily inside a function (the port keeps its own copy of what it
needs). Each line the rule must flag ends in ``# expect``."""
import torch

from bitcoin_miner_tpu.core import sha256  # expect


def digest(data: bytes) -> bytes:
    return sha256.sha256d(data)


def jitted():
    import jax  # expect

    return jax.jit(torch.zeros)
