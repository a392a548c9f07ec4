"""Measurement probes of the card: the counterparts of the reference's
``benchmarks/`` scripts, run as ``python -m
bitcoin_miner_tpu_torch.probes.<name>``."""
