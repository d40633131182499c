"""Optimal assignment (Hungarian-equivalent) for small tracking problems.

Counterpart of ``low_cost_mocap_tpu/ops/assignment.py``.  The association
problems here are tiny (track slots x per-frame fits, both <= 8), so the
min-cost matching is exhaustive: every row of the static (n!, n)
permutation table is costed at once and the cheapest wins.

The JAX package contracts a one-hot of the table with the cost matrix.
Here each permutation's cost is a gather of its n entries, summed in a
fixed order (entry 0, then 1, ...), so the totals do not depend on a
library's reduction order and the card and the CPU agree.  Ties go to the
lowest permutation row, as ``jnp.argmin`` gives them.  The table is built
once per (n, device) and kept on the device: an upload per frame would
be a host-to-device copy on every served frame.
"""

from __future__ import annotations

import functools
import itertools

import numpy as np
import torch

MAX_EXACT = 8  # 8! = 40,320 permutations


@functools.lru_cache(maxsize=16)
def _perm_table(n: int) -> np.ndarray:
    """(n!, n) int32 table of all permutations of range(n)."""
    return np.asarray(list(itertools.permutations(range(n))), np.int32)


@functools.cache
def _perm_table_on(n: int, device: torch.device):
    """The permutation table on ``device``, int64 for indexing, and the
    flat cost index of each of its entries, ``row * n + perm[p, row]``.
    Kept for the life of the process: a captured graph reads it by
    address."""
    perms = torch.as_tensor(_perm_table(n), dtype=torch.int64,
                            device=device)
    flat = perms + n * torch.arange(n, dtype=torch.int64, device=device)
    return perms, flat


def assign(cost):
    """Min-cost perfect matching on a square (N, N) cost matrix, N <= 8.

    Returns (col_of_row (N,) int64, total_cost ()).  Infeasible pairs
    should carry a large finite cost, not inf, which would poison every
    permutation containing it.
    """
    N = cost.shape[0]
    if N > MAX_EXACT:
        raise ValueError(f"exact assignment supports N <= {MAX_EXACT}, "
                         f"got {N} (use greedy association above that)")
    perms, flat = _perm_table_on(N, cost.device)
    picked = cost.reshape(-1)[flat]                      # (P, N)
    totals = picked[:, 0]
    for i in range(1, N):
        totals = totals + picked[:, i]
    # a (1,) index: a 0-d one reads it back to the host (``Tensor.item``)
    best = torch.argmin(totals).reshape(1)
    return perms[best][0], totals[best][0]
