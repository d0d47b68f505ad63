"""`device_cond` and `fixed_rounds` in their branch form.

Copied from `trajopt_tpu_torch/runtime/graph.py` as of commit 35ea473,
the form it takes outside a capture (a Python branch on one host read),
which is what the program runs on the CPU.
"""

from __future__ import annotations

from typing import Callable

import torch


def device_cond(pred: torch.Tensor, true_fn: Callable, false_fn: Callable, *operands):
    """``lax.cond(pred, true_fn, false_fn, *operands)`` for a 0-d bool tensor."""
    return true_fn(*operands) if bool(pred) else false_fn(*operands)


def fixed_rounds(rounds: int, pred_fn: Callable, body_fn: Callable, *carry):
    """At most ``rounds`` rounds of ``carry = body_fn(*carry)``, each taken
    while ``pred_fn(*carry)`` holds."""
    for _ in range(rounds):
        if not bool(pred_fn(*carry)):
            break
        carry = body_fn(*carry)
    return carry
