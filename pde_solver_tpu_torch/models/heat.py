"""Coordinate embeddings for output fields (the part of
``pde_solver_tpu.models.heat`` the elasticity slice needs)."""

from __future__ import annotations

import numpy as np


def embed_identity3(coords: np.ndarray) -> np.ndarray:
    return coords.copy()
