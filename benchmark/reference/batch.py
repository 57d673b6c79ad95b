"""Ragged id rows as one padded batch, for the comparison in check.py and
for any architecture's reference."""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch


def pad(rows: Sequence[Sequence[int]], device, fill: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Ragged id rows → ([N, L] long, [N, L] bool mask)."""
    width = max(1, max(len(r) for r in rows))
    ids = np.full((len(rows), width), fill, np.int64)
    mask = np.zeros((len(rows), width), bool)
    for i, row in enumerate(rows):
        ids[i, :len(row)] = row
        mask[i, :len(row)] = True
    return torch.from_numpy(ids).to(device), torch.from_numpy(mask).to(device)
