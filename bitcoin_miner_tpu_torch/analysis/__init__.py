"""miner-lint: the project-specific concurrency and invariant analyzer.

Counterpart of ``bitcoin_miner_tpu/analysis``. ``python -m
bitcoin_miner_tpu_torch lint`` dispatches to :func:`engine.main` before
anything loads torch; importing :mod:`rules`/:mod:`docdrift` registers
the rule set.

Import-safe by contract (imports neither torch nor jax, enforced on
itself by the ``device-claiming-import`` rule): the lint runs on any
host, with or without a card.
"""

from .engine import (  # noqa: F401
    Finding,
    RULES,
    SCHEMA,
    lint_source,
    main,
    run_lint,
)
