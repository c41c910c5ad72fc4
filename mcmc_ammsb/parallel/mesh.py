"""Mesh construction helpers."""

from __future__ import annotations

from typing import Optional, Tuple

import jax
from jax.sharding import Mesh

DATA_AXIS = "data"
MODEL_AXIS = "model"


def make_mesh(n_data: Optional[int] = None,
              n_model: Optional[int] = None,
              allow_subset: bool = False) -> Mesh:
    """Build a ('data', 'model') mesh over the available devices.

    Default split: model axis as large as possible up to 4 (pi rows
    sharded for capacity), rest data-parallel. The cards of one host are
    joined all to all, so the mesh follows the algorithm alone.

    An explicit shape must cover every device unless ``allow_subset``
    is set (used by cross-mesh golden tests that deliberately run a
    small mesh on a big host); silently leaving chips idle in
    production would be a provisioning bug, so it raises by default.
    """
    devices = jax.devices()
    n = len(devices)
    if n_data is None or n_model is None:
        n_model = min(4, n)
        while n % n_model:
            n_model //= 2
        n_data = n // n_model
    need = n_data * n_model
    if need > n:
        raise ValueError(f"mesh {n_data}x{n_model} needs {need} devices, "
                         f"only {n} available")
    if need < n and not allow_subset:
        raise ValueError(
            f"mesh {n_data}x{n_model} uses {need} of {n} devices; pass "
            "allow_subset=True to deliberately leave chips idle")
    return jax.make_mesh((n_data, n_model), (DATA_AXIS, MODEL_AXIS),
                         devices=devices[:need])
